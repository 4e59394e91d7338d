"""The port's ops against the JAX package's, on the CPU. (K1-K4 against
their plain twins on a CUDA card: tests/test_torch_kernels.py.)

Inputs are drawn by numpy from a seed and handed to both frameworks. fp32
comparisons use the repo's oracle tolerance, atol 2e-5
(tests/test_tf_parity.py:43). The kernels' own index arithmetic (the host
arrays the CUDA entries read) is replayed in numpy and held to flax too, so
the windows, phases and strides the card will use are checked here.
"""

import collections
import functools
import itertools
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
from test_torch_conv_halo import _tf32, replay_wgmma

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


def _emulate_fp32(parts, kernel, bias, strides, transposed, arith="float64"):
    """The fp32 kernel's schedule (csrc/conv3d_wgmma.cu, the wrapper's own
    host arrays) replayed in numpy: ``arith`` "float64" sums the exact
    products, "3xtf32" the kernel's arithmetic, "tf32" hi*hi alone
    (test_torch_conv_halo.replay_wgmma)."""
    return replay_wgmma(parts, kernel, bias, strides, transposed, torch.float32, arith)[0]


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
    np.testing.assert_allclose(  # the fp32 kernel's schedule
        _emulate_fp32(parts, kernel, bias, st, transposed=False), want, atol=ATOL)
    rp, rk = [_bf16(p) for p in parts], _bf16(kernel)  # the bf16 kernel's schedule
    np.testing.assert_allclose(replay_wgmma(rp, rk, bias, st, False)[0],
                               _flax_split_conv(rp, rk, bias, ks, st), atol=ATOL)


def _bf16(a):
    """The bf16 value of each element, as float32."""
    return _t(a).to(torch.bfloat16).float().numpy()


@pytest.fixture
def fresh_wgmma_plans():
    """The bf16 kernel's host arrays are cached by shapes; a test that
    patches the plan's constants plans afresh, before and after."""
    tconv._wgmma_host.cache_clear()
    yield
    tconv._wgmma_host.cache_clear()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ks", [(1, 3, 3), (3, 3, 3)])
def test_six_part_stitch_schedule_matches_flax(ks, dtype, monkeypatch, fresh_wgmma_plans):
    """A dense-skip ladder's stage-0 stitch has six parts (the upsampled
    features, four decoder parts, the gated skip): the kernel's replay over
    MAX_PARTS parts of mixed widths and routes (bf16: 8 and 16 by TMA, the
    rest staged; fp32: 8, 16 and 4 by TMA, 5 and 3 staged), K split
    finely; fp32 also in the kernel's 3xTF32 arithmetic."""
    monkeypatch.setattr(tconv, "WG_MIN_STAGES_PER_SPLIT", 1)
    rng = np.random.default_rng(_seed(ks, str(dtype), "six"))
    widths = (8, 5, 16, 3, 8, 4)
    assert len(widths) == tconv.MAX_PARTS
    parts = _parts(rng, SIZES["odd"], widths)
    kernel = (rng.normal(size=(*ks, sum(widths), 6)) / 8).astype(np.float32)
    bias = rng.normal(size=(6,)).astype(np.float32)
    want = _flax_split_conv(parts, kernel, bias, ks, (1, 1, 1))
    got = tconv.conv3d([_t(p) for p in parts], _t(kernel), _t(bias))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    if dtype == torch.bfloat16:  # the schedule in exact arithmetic on bf16 operands
        rp, rk = [_bf16(p) for p in parts], _bf16(kernel)
        got, plan = replay_wgmma(rp, rk, bias, (1, 1, 1), False)
        np.testing.assert_allclose(got, _flax_split_conv(rp, rk, bias, ks, (1, 1, 1)),
                                   atol=ATOL)
    else:
        got, plan = replay_wgmma(parts, kernel, bias, (1, 1, 1), False, dtype)
        np.testing.assert_allclose(got, want, atol=ATOL)
        fast = replay_wgmma(parts, kernel, bias, (1, 1, 1), False, dtype, "3xtf32")[0]
        assert _rel_err(fast, want) <= FP32_LIMIT
    assert plan["splits"] > 1
    _, _, _, (ptrs, meta, _) = tconv.wgmma_args(
        [_t(p).to(dtype) for p in parts], _t(kernel).to(dtype), _t(bias), (1, 1, 1), False)
    assert meta[0] == 6 and list(meta[1:7]) == list(widths) and ptrs.size == 6 + 4
    chunk = 16 // torch.empty((), dtype=dtype).element_size()
    # parts whose boxes go by TMA: 16-byte voxel strides
    assert meta[13] == sum(1 << i for i, w in enumerate(widths) if w % chunk == 0)
    with pytest.raises(ValueError, match="parts"):
        tconv._check_cuda_args("conv3d", [_t(parts[0])] * 7, _t(kernel), None, 3)


def test_part_limit_is_the_kernels():
    """MAX_PARTS and the kernel's kMaxParts (csrc/conv_params.cuh) agree."""
    import os
    import re

    src = os.path.join(os.path.dirname(tconv.__file__), "..", "csrc", "conv_params.cuh")
    with open(src) as f:
        got = int(re.search(r"constexpr int kMaxParts = (\d+);", f.read()).group(1))
    assert got == tconv.MAX_PARTS == 6


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
    np.testing.assert_allclose(  # the fp32 kernel's schedule
        _emulate_fp32([x], kernel, bias, st, transposed=True), want, atol=ATOL)
    rx, rk = _bf16(x), _bf16(kernel)  # the bf16 kernel's schedule
    np.testing.assert_allclose(replay_wgmma([rx], rk, bias, st, True)[0],
                               _flax_convt(rx, rk, bias, ks, st), atol=ATOL)


def test_transpose_plan_phases_partition_the_taps():
    plan = tconv.transpose_plan((3, 3, 3), (2, 2, 2), (5, 10, 10))
    assert len(plan["phases"]) == 8
    used = sorted(t[3] for _, taps in plan["phases"] for t in taps)
    assert used == list(range(27))  # each tap feeds exactly one phase


# ------------------------------------------ K1/K2 fp32 schedule (wgmma)
@pytest.mark.parametrize("ks,st,transposed", [(ks, st, False) for ks, st in CONV_CASES]
                         + [(ks, st, True) for ks, st in CONVT_CASES])
def test_igemm_split_schedule_matches_flax(ks, st, transposed, monkeypatch,
                                           fresh_wgmma_plans):
    """The implicit-GEMM schedule in fp32 with its two box routes (TMA: K1
    cin 16, K2 cin 64; staged: K1 cin 3), with K split as finely as the
    plan allows (one weight stage in the shortest phase, on a card of
    enough SMs that K, not the wave, bounds the splits), so the workspace
    and the ordered reduce are walked (bf16's: tests/test_torch_conv_halo.py)."""
    monkeypatch.setattr(tconv, "WG_MIN_STAGES_PER_SPLIT", 1)
    monkeypatch.setattr(tconv, "SMS", 8 * tconv.SMS)
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
    _, _, plan, (_, meta, _) = tconv.wgmma_args(
        [_t(p) for p in parts], _t(kernel), None, st, transposed)
    assert plan["splits"] == min(plan["stages"]) > 1
    assert meta[13] == 1  # part 0 by TMA, a K1's part 1 (cin 3) staged
    np.testing.assert_allclose(_emulate_fp32(parts, kernel, bias, st, transposed),
                               want_fn(bias), atol=ATOL)


# --------------------------------------------- K1/K2 fp32 by 3xTF32 (replay)
FP32_LIMIT = 2e-4  # kernel vs twin in fp32, |diff| / max(1, |ref|)


def _rel_err(got, want):
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max())


def test_tf32_rounding_is_nearest_with_ties_away():
    tie = 1 + 2.0 ** -11  # halfway between 1 and the next TF32 value
    x = np.array([tie, -tie, tie - 2.0 ** -23, 1 + 3 * 2.0 ** -11, 2.0 ** -11], np.float32)
    want = np.array([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1, 1 + 2.0 ** -9, 2.0 ** -11],
                    np.float32)
    np.testing.assert_array_equal(_tf32(x), want)
    r = np.random.default_rng(0).normal(size=1000).astype(np.float32)
    assert not (_tf32(r).view(np.uint32) & 0x1FFF).any()
    assert np.abs(_tf32(r) - r).max() <= 2.0 ** -11 * np.abs(r).max()


def _fp32_case(ks, st, transposed, spatial, widths, cout, batch=2):
    """Inputs drawn by numpy, the kernel scaled by 1/sqrt(fan-in) as the
    model's weights are, and flax's fp32 conv of them."""
    rng = np.random.default_rng(_seed(ks, st, transposed, widths, "fp32"))
    parts = _parts(rng, spatial, widths, batch)
    fan_in = int(np.prod(ks)) * sum(widths)
    kshape = (*ks, cout, widths[0]) if transposed else (*ks, sum(widths), cout)
    kernel = (rng.normal(size=kshape) / np.sqrt(fan_in)).astype(np.float32)
    bias = (0.1 * rng.normal(size=(cout,))).astype(np.float32)
    want = (_flax_convt(parts[0], kernel, bias, ks, st) if transposed
            else _flax_split_conv(parts, kernel, bias, ks, st))
    return parts, kernel, bias, want


@pytest.mark.parametrize("ks,st,transposed", [(ks, st, False) for ks, st in CONV_CASES]
                         + [(ks, st, True) for ks, st in CONVT_CASES])
def test_fp32_3xtf32_replay_matches_flax(ks, st, transposed):
    """The fp32 schedule (32-deep weight stages, 8-deep TF32 steps, a TMA
    box of cin 16 beside the staged one of cin 3) in the kernel's 3xTF32
    arithmetic holds the fp32 limit against flax at every conv of the path,
    K1 and K2."""
    widths, cout = ((12,), 4) if transposed else ((16, 3), 8)
    parts, kernel, bias, want = _fp32_case(ks, st, transposed, SIZES["odd"], widths, cout)
    got = _emulate_fp32(parts, kernel, bias, st, transposed, "3xtf32")
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _rel_err(got, want) <= FP32_LIMIT


@functools.lru_cache(maxsize=1)
def _deepest_stitch():
    """The deepest stitch of the path in miniature: two 128-channel parts,
    3x3x3 taps, K = 6,912 (split-K walks 54 splits of 4 weight stages)."""
    return _fp32_case((3, 3, 3), (1, 1, 1), False, (3, 4, 5), (128, 128), 8, batch=1)


@pytest.mark.parametrize("arith,holds", [("3xtf32", True), ("tf32", False)])
def test_fp32_limit_at_the_deepest_stitch_needs_the_compensation(arith, holds):
    """3xTF32 holds 2e-4 at K = 6,912; one TF32 product (hi*hi) misses it."""
    parts, kernel, bias, want = _deepest_stitch()
    plan = tconv.wgmma_args([_t(p) for p in parts], _t(kernel), None, (1, 1, 1), False)[2]
    assert plan["stages"] == (6912 // tconv.WG_KSTAGE[torch.float32],) and plan["splits"] > 1
    err = _rel_err(_emulate_fp32(parts, kernel, bias, (1, 1, 1), False, arith), want)
    assert (err <= FP32_LIMIT) == holds, err


def test_fp32_level0_bottleneck_takes_the_vector_gather():
    """Level 0's bottleneck convs read 4-channel parts: a 16-byte voxel in
    fp32, so their boxes go by TMA, which bf16 (8 a chunk) cannot."""
    narrow = [(name, sig) for name, sig in _path_convs(2)
              if name == "conv3d" and any(s[-1] == 4 for s in sig[0])]
    assert narrow
    for name, sig in narrow:
        fp32 = _path_plan(name, sig, torch.float32)[2]["tma"]
        bf16 = _path_plan(name, sig, torch.bfloat16)[2]["tma"]  # a box by TMA, else staged
        for i, shape in enumerate(sig[0]):
            assert fp32[i] == (shape[-1] % 4 == 0)
            assert bf16[i] == (shape[-1] % 8 == 0)
        assert any(s[-1] == 4 and t for s, t in zip(sig[0], fp32))


def _path_convs(batch):
    """Every distinct K1/K2 call of the cfg1 forward at ``batch`` (the
    serve path's 2, serve_mc's 8, serve_sw's 16): (name, signature)."""
    import chip_smoke

    return [key for key in chip_smoke.trace_path_calls(batch)
            if key[0] in ("conv3d", "conv3d_transpose")]


DTYPES = (torch.bfloat16, torch.float32)


def _path_plan(name, sig, dtype):
    """The wrapper's launch arguments of one path call in ``dtype``
    (wgmma_args), on the meta device."""
    transposed = name == "conv3d_transpose"
    shapes = [sig[0]] if transposed else sig[0]
    parts = [torch.empty(s, dtype=dtype, device="meta") for s in shapes]
    kernel = torch.empty(sig[1], dtype=dtype, device="meta")
    return tconv.wgmma_args(parts, kernel, None, sig[2], transposed)


def _k_units(plan, dtype):
    """A phase's units of K that split-K divides (its weight stages), with
    the dtype's tile widths, the least average a split keeps and the blocks
    an SM holds of each width."""
    return (plan["stages"], tconv.WG_TILES_N[dtype], tconv.WG_MIN_STAGES_PER_SPLIT,
            tconv.WG_RESIDENT[dtype])


@pytest.mark.parametrize("batch", [2, 8, 16])
def test_igemm_plan_splits_partition_k(batch):
    for (name, sig), dtype in itertools.product(_path_convs(batch), DTYPES):
        plan = _path_plan(name, sig, dtype)[2]
        units, widths, _, _ = _k_units(plan, dtype)
        assert plan["bn"] in widths
        assert len(plan["ranges"]) == len(units)
        for n, ranges in zip(units, plan["ranges"]):
            assert len(ranges) == plan["splits"]
            assert ranges[0][0] == 0 and ranges[-1][1] == n, (name, sig)
            assert all(lo < hi for lo, hi in ranges), (name, sig)  # none empty
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("batch", [2, 8, 16])
def test_igemm_plan_fills_the_grid_or_runs_out_of_k(batch):
    """Split K into the most splits that keep the grid within one wave of
    the card (the target), or as far as K allows."""
    split_shapes = collections.Counter()
    for (name, sig), dtype in itertools.product(_path_convs(batch), DTYPES):
        plan = _path_plan(name, sig, dtype)[2]
        slabs, _, least, resident = _k_units(plan, dtype)
        cap = max(1, min(min(slabs), sum(slabs) // (len(slabs) * least), tconv.MAX_SPLITS))
        assert plan["cap"] == cap
        assert plan["target"] == tconv.SMS * resident[plan["bn"]] * tconv.WG_SPLIT_WAVES[dtype]
        if plan["splits"] > 1:
            assert plan["blocks"] <= plan["target"], (name, sig, plan)
        assert (plan["splits"] == cap  # K ran out
                or plan["tiles"] * (plan["splits"] + 1) > plan["target"]), (name, sig, plan)
        split_shapes[dtype] += plan["splits"] > 1
    # both dtypes' plans split at 2; at 8 and 16 every call's tiles of 128
    # rows already hold (nearly) a wave's worth of blocks (target // tiles
    # is 1)
    assert batch > 2 or (split_shapes[torch.float32] > 0 and split_shapes[torch.bfloat16] > 0)


@pytest.mark.parametrize("batch", [2, 8, 16])
def test_igemm_plan_workspace_is_what_the_wrapper_allocates(batch):
    for (name, sig), dtype in itertools.product(_path_convs(batch), DTYPES):
        y, ws, plan, (ptrs, meta, _) = _path_plan(name, sig, dtype)
        # the kernel's fields (_wgmma_host)
        assert meta[89] == (1 if dtype == torch.bfloat16 else 0)
        assert meta[81] == plan["splits"] and meta[83] == plan["bn"]
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


# ------------------------------------------------------ K3's grid (plan)
def _path_norm_shapes(batch):
    """The distinct K3 input shapes of the cfg1 forward at ``batch``."""
    import chip_smoke

    return sorted({sig[0] for name, sig in chip_smoke.trace_path_calls(batch)
                   if name == "in_stats"})


def _thread_vectors(plan, r0, r1):
    """The vectors (row * groups + group) that in_stats_kernel's threads
    visit in the chunk of rows [r0, r1), as the kernel's loops walk them."""
    g = plan["groups"]
    if g > 256:  # each thread walks every row of groups tid, tid + 256, ...
        return [row * g + cg for cg in range(g) for row in range(r0, r1)]
    rpass = 256 // g
    return [(r0 + r) * g + cg + i * rpass * g
            for r in range(rpass) for cg in range(g)
            for i in range(-(-(r1 - r0 - r) // rpass))]


@pytest.mark.parametrize("itemsize", [2, 4])
def test_in_stats_plan_covers_every_element_of_the_path_shapes_once(itemsize):
    shapes = _path_norm_shapes(2)
    assert len(shapes) == 10
    for shape in shapes:
        b, c = shape[0], shape[-1]
        spatial = int(np.prod(shape[1:4]))
        plan = tnorm.in_stats_plan(b, spatial, c, itemsize)
        assert plan["route"] == "vector" and plan["vec"] == 16 // itemsize
        assert plan["rows"] * plan["groups"] * plan["vec"] == spatial * c
        bounds = [(k * plan["chunk_rows"], min(plan["rows"], (k + 1) * plan["chunk_rows"]))
                  for k in range(plan["nchunk"])]
        assert bounds[0][0] == 0 and bounds[-1][1] == plan["rows"]
        assert all(lo < hi for lo, hi in bounds) and all(
            x[1] == y[0] for x, y in zip(bounds, bounds[1:]))
        for lo, hi in (bounds[0], bounds[-1]):  # every vector of a chunk once
            assert sorted(_thread_vectors(plan, lo, hi)) == list(
                range(lo * plan["groups"], hi * plan["groups"])), shape
        assert plan["nchunk"] == 1 or 2 * c * plan["nchunk"] <= tnorm.STAT_FOLD_FLOATS


def test_in_stats_plan_fills_the_card_where_the_tensor_is_large_enough():
    """At least 132 blocks for every path shape of 1 MB or more a sample
    whose partials fit the fold (C <= 64 at batch 2); fewer only where a
    cap binds: 4 KB chunks or the fold's 16K floats."""
    for shape in _path_norm_shapes(2):
        b, c = shape[0], shape[-1]
        spatial = int(np.prod(shape[1:4]))
        plan = tnorm.in_stats_plan(b, spatial, c, 2)
        if spatial * c * 2 >= 2 ** 20 and c <= 64:
            assert plan["blocks"] >= tnorm.SMS, (shape, plan)
        elif plan["blocks"] < tnorm.SMS:
            chunk_bytes = plan["chunk_rows"] * plan["groups"] * plan["vec"] * 2
            assert (chunk_bytes >= tnorm.STAT_MIN_CHUNK_BYTES
                    or 2 * c * plan["nchunk"] * 2 > tnorm.STAT_FOLD_FLOATS), (shape, plan)


@pytest.mark.parametrize("c,itemsize,aligned,route,vec,groups", [
    (4, 2, True, "vector", 8, 1), (8, 2, True, "vector", 8, 1), (16, 2, True, "vector", 8, 2),
    (8, 4, True, "vector", 4, 2), (300, 4, True, "vector", 4, 75), (12, 2, True, "scalar", 1, 12),
    (300, 2, True, "scalar", 1, 300), (16, 2, False, "scalar", 1, 16)])
def test_in_stats_plan_routes(c, itemsize, aligned, route, vec, groups):
    plan = tnorm.in_stats_plan(2, 6 * 16 * 16, c, itemsize, aligned)
    assert (plan["route"], plan["vec"], plan["groups"]) == (route, vec, groups)


@pytest.mark.parametrize("batch,spatial,c,itemsize", [
    (0, 8, 4, 2), (65536, 8, 4, 2), (2, 0, 4, 2), (2, 8, 0, 2), (2, 8, 4, 8),
    (1, 2 ** 28, 8, 2)])
def test_in_stats_plan_refuses_what_the_kernel_does_not_take(batch, spatial, c, itemsize):
    with pytest.raises(ValueError):
        tnorm.in_stats_plan(batch, spatial, c, itemsize)


def _emulate_in_stats(xv, itemsize):
    """numpy replay of csrc/instance_norm.cu in_stats_kernel on the values
    ``xv`` (B, D, H, W, C): the plan's rows of ``groups`` vectors, each
    lane's channel as the kernel computes it ((group * vec + lane) % C),
    per-chunk partials, and the fold: bf16 one pass, fp32 two passes about
    the first pass's mean."""
    b, c = xv.shape[0], xv.shape[-1]
    spatial = int(np.prod(xv.shape[1:4]))
    plan = tnorm.in_stats_plan(b, spatial, c, itemsize)
    vec, g, rows, cr = plan["vec"], plan["groups"], plan["rows"], plan["chunk_rows"]
    flat = xv.reshape(b, rows, g, vec).astype(np.float64)
    ch = (np.arange(g)[:, None] * vec + np.arange(vec)[None, :]) % c
    elem = (np.arange(rows)[:, None, None] * g + np.arange(g)[None, :, None]) * vec \
        + np.arange(vec)
    assert ((elem % c) == ch[None]).all()  # a lane always meets its own channel

    def one_pass(center):
        part = np.zeros((b, plan["nchunk"], 2, c))
        for k in range(plan["nchunk"]):
            blk = flat[:, k * cr:min(rows, (k + 1) * cr)]
            if center is not None:
                blk = blk - center[:, ch][:, None]
            for i in range(b):
                np.add.at(part[i, k, 0], ch, blk[i].sum(0))
                np.add.at(part[i, k, 1], ch, (blk[i] ** 2).sum(0))
        return part.sum(1) / spatial  # the fold: (B, 2, C)

    first = one_pass(None)
    mean = first[:, 0]
    if itemsize == 2:
        var = np.maximum(first[:, 1] - mean ** 2, 0.0)
    else:
        var = one_pass(mean)[:, 1]
    return torch.from_numpy(np.stack([mean, var], 1).astype(np.float32))


@pytest.mark.parametrize("c", [4, 8, 12, 16, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_in_stats_kernel_emulation_matches_jax(c, dtype):
    """The kernel's partition and channel map, through K4's twin, against
    the JAX package's instance norm."""
    x, _, _ = _in_inputs(7 + c, c=c, spatial=(3, 8, 10))
    rng = np.random.default_rng(c)
    scale = (1 + 0.3 * rng.normal(size=(c,))).astype(np.float32)
    bias = (0.3 * rng.normal(size=(c,))).astype(np.float32)
    xt = _t(x).to(getattr(torch, dtype))
    stats = _emulate_in_stats(xt.float().numpy(), xt.element_size())
    got = tnorm.in_apply_plain(xt, stats, _t(scale), _t(bias)).float().numpy()
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want = np.asarray(jnorm.instance_norm(xj, jnp.asarray(scale), jnp.asarray(bias))
                      .astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL)
    else:
        err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
        assert err.max() <= BF16_REL, err.max()


# ------------------------------------------------------ K4's grid (plan)
def _apply_visits(plan):
    """How often in_apply_kernel's threads visit each vector of a sample,
    walking the kernel's loop: thread i < active takes rounds of vectors
    v + k * active (k < APPLY_UNROLL, those inside the sample) from v = i,
    v advancing APPLY_UNROLL * active a round while it lies in the sample."""
    nvec, active, unroll = plan["vectors"], plan["active"], tnorm.APPLY_UNROLL
    assert plan["groups"] <= active <= plan["blocks_per_sample"] * tnorm.THREADS
    assert active % plan["groups"] == 0
    hits = np.zeros(nvec, np.int64)
    v = np.arange(active)
    while (live := v < nvec).any():
        for k in range(unroll):
            idx = v[live] + k * active
            hits[idx[idx < nvec]] += 1
        v = v + unroll * active
    return hits


def _apply_channels(plan, c):
    """(vectors, vec) channels of each lane as the kernel builds them, from
    the thread's fixed group: ((i % groups) * vec + lane) % C, i = v % active;
    held to each element's own channel."""
    vec = plan["vec"]
    v = np.arange(plan["vectors"])
    ch = (((v % plan["active"]) % plan["groups"])[:, None] * vec + np.arange(vec)) % c
    assert (ch == (v[:, None] * vec + np.arange(vec)) % c).all()
    return ch


@pytest.mark.parametrize("itemsize", [2, 4])
def test_in_apply_plan_covers_every_element_of_the_path_shapes_once(itemsize):
    shapes = _path_norm_shapes(2)
    assert len(shapes) == 10
    for shape in shapes:
        b, c = shape[0], shape[-1]
        spatial = int(np.prod(shape[1:4]))
        plan = tnorm.in_apply_plan(b, spatial, c, itemsize)
        assert plan["route"] == "vector" and plan["vec"] == 16 // itemsize
        assert plan["vectors"] * plan["vec"] == spatial * c
        assert (_apply_visits(plan) == 1).all(), shape
        _apply_channels(plan, c)


def test_in_apply_plan_sizes_the_grid_from_bytes():
    """The level-0 shapes get the blocks that keep APPLY_INFLIGHT_BYTES in
    flight on every SM; the small deep shapes only one pass's worth."""
    target = tnorm.SMS * tnorm.APPLY_INFLIGHT_BYTES // (
        tnorm.THREADS * tnorm.APPLY_UNROLL * 16)
    assert target == 2 * tnorm.SMS
    for shape in _path_norm_shapes(2):
        b, c = shape[0], shape[-1]
        plan = tnorm.in_apply_plan(b, int(np.prod(shape[1:4])), c, 2)
        one_pass = -(-plan["vectors"] // (tnorm.THREADS * tnorm.APPLY_UNROLL))
        assert plan["blocks_per_sample"] == min(-(-target // b), one_pass), (shape, plan)
        if shape[2] == 160:
            assert plan["blocks"] == target
        if shape[1] * shape[2] * shape[3] * c * 2 <= 100_000:
            assert plan["blocks"] <= 32


@pytest.mark.parametrize("c,itemsize,aligned,route,vec,groups", [
    (4, 2, True, "vector", 8, 1), (8, 2, True, "vector", 8, 1), (16, 2, True, "vector", 8, 2),
    (8, 4, True, "vector", 4, 2), (300, 4, True, "vector", 4, 75), (12, 2, True, "scalar", 1, 12),
    (300, 2, True, "scalar", 1, 300), (16, 2, False, "scalar", 1, 16)])
def test_in_apply_plan_routes(c, itemsize, aligned, route, vec, groups):
    plan = tnorm.in_apply_plan(2, 6 * 16 * 16, c, itemsize, aligned)
    assert (plan["route"], plan["vec"], plan["groups"]) == (route, vec, groups)
    assert (_apply_visits(plan) == 1).all()


@pytest.mark.parametrize("batch,spatial,c,itemsize", [
    (0, 8, 4, 2), (65536, 8, 4, 2), (2, 0, 4, 2), (2, 8, 0, 2), (2, 8, 4, 8),
    (1, 2 ** 28, 8, 2)])
def test_in_apply_plan_refuses_what_the_kernel_does_not_take(batch, spatial, c, itemsize):
    with pytest.raises(ValueError):
        tnorm.in_apply_plan(batch, spatial, c, itemsize)


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _emulate_in_apply(xt, stats, scale, bias, lrelu, eps=tnorm.EPSILON):
    """numpy replay of csrc/instance_norm.cu in_apply_kernel: the plan's
    partition, each thread's coefficients for its fixed channels, fp32
    arithmetic (bf16: a and b rounded to bf16 first), one rounding."""
    b, c = xt.shape[0], xt.shape[-1]
    plan = tnorm.in_apply_plan(b, int(np.prod(xt.shape[1:4])), c, xt.element_size())
    assert (_apply_visits(plan) == 1).all()
    ch = _apply_channels(plan, c)
    st = stats.numpy().astype(np.float32)
    mean, var = st[:, 0][:, ch], st[:, 1][:, ch]
    a = np.float32(1) / np.sqrt(var + np.float32(eps)) * scale.numpy()[ch]
    if xt.dtype == torch.float32:
        center, off = mean, bias.numpy()[ch]
    else:
        center, off, a = np.float32(0), _bf16(bias.numpy()[ch] - mean * a), _bf16(a)
    y = (xt.float().numpy().reshape(b, -1, plan["vec"]) - center) * a + off
    if lrelu:
        y = np.where(y < 0, np.float32(0.1) * y, y)
    return torch.from_numpy(y.astype(np.float32).reshape(xt.shape)).to(xt.dtype)


@pytest.mark.parametrize("lrelu", [False, True])
@pytest.mark.parametrize("c", [4, 8, 12, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_in_apply_kernel_emulation_matches_jax(dtype, c, lrelu):
    """K4's partition and channel map, on K3's replayed statistics, against
    the JAX package's instance norm (+ LReLU 0.1)."""
    x, _, _ = _in_inputs(20 + c, c=c, spatial=(3, 8, 10))
    rng = np.random.default_rng(c + 1)
    scale = (1 + 0.3 * rng.normal(size=(c,))).astype(np.float32)
    bias = (0.3 * rng.normal(size=(c,))).astype(np.float32)
    xt = _t(x).to(getattr(torch, dtype))
    stats = _emulate_in_stats(xt.float().numpy(), xt.element_size())
    got = _emulate_in_apply(xt, stats, _t(scale), _t(bias), lrelu)
    assert got.dtype == xt.dtype
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want = jnorm.instance_norm(xj, jnp.asarray(scale), jnp.asarray(bias))
    if lrelu:
        want = fnn.leaky_relu(want, 0.1)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL)
    else:
        err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
        assert err.max() <= BF16_REL, err.max()


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
