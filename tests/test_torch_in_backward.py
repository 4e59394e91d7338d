"""K7 ``in_backward``'s grid and arithmetic, on the CPU.

``in_backward_plan`` gives both of K7's launches one grid: block (chunk, b)
takes a chunk of sample b's rows, pass 1 (in_bwd_reduce_kernel) ascending
and pass 2 (in_bwd_apply_kernel) descending. The threads' walks of
csrc/instance_norm.cu are replayed here in numpy at the 10 instance-norm
shapes of a cfg1 train step, both element sizes and the scalar route. The
kernel's arithmetic (per-chunk partials scaled by rstd, folded in chunk
order in fp64; dx = fma(kx, g', fma(p, x - mean, q))) is replayed on numpy
inputs and held to the JAX package's vjp. (The kernel itself against its twin on
a card: tests/test_torch_kernels.py.)
"""

import functools
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prostatemr_3d_cad_cspca_tpu.ops.normalization import instance_norm as jinstance_norm
from prostatemr_3d_cad_cspca_tpu_torch.ops import normalization as nm

SOURCE = os.path.join(os.path.dirname(nm.__file__), os.pardir, "csrc", "instance_norm.cu")
THREADS = 256
# the x shapes of K7's calls in a cfg1 batch-2 train step
TRAIN_SHAPES = [
    (2, 20, 160, 160, 16), (2, 20, 80, 80, 32), (2, 20, 40, 40, 64), (2, 20, 160, 160, 4),
    (2, 20, 80, 80, 8), (2, 20, 40, 40, 16), (2, 10, 20, 20, 128), (2, 10, 20, 20, 32),
    (2, 5, 10, 10, 256), (2, 5, 10, 10, 64)]
PLAN_CASES = [(s, i, a) for s in TRAIN_SHAPES for i in (2, 4) for a in (True, False)]
PLAN_IDS = [f"{'x'.join(map(str, s[1:]))}-{i}B-{'vector' if a else 'scalar'}"
            for s, i, a in PLAN_CASES]


def _plan(shape, itemsize, aligned):
    return nm.in_backward_plan(shape[0], math.prod(shape[1:4]), shape[-1], itemsize, aligned)


@functools.lru_cache(maxsize=None)
def _walks(shape, itemsize, aligned):
    """Each pass's visits of one sample, as the kernels' loops make them:
    arrays (chunk, thread, step, vector) over every vector a thread loads,
    vector = row * groups + column group. Threads of a row-step are cg =
    tid % G, r = tid // G (r < R rows a step); where a row is wider than
    the block (G > 256) thread tid takes groups tid, tid + 256, ... and
    every row, one a step."""
    plan = _plan(shape, itemsize, aligned)
    g, rows, cr, nchunk = plan["groups"], plan["rows"], plan["chunk_rows"], plan["nchunk"]
    k = np.arange(nchunk)[:, None, None]
    r0, r1 = k * cr, np.minimum(rows, (k + 1) * cr)
    out = {}
    if g <= THREADS:
        big_r = THREADS // g  # rows a step
        t = np.arange(big_r * g)[None, :, None]  # threads with r < R
        cg, r = t % g, t // g
        j = np.arange(-(-cr // big_r))[None, None, :]
        for name, row in (("pass1", r0 + r + j * big_r), ("pass2", r1 - big_r + r - j * big_r)):
            ok = (row >= r0) & (row < r1)
            vec = row * g + cg
            shp = np.broadcast_shapes(k.shape, t.shape, j.shape)
            out[name] = tuple(np.broadcast_to(a, shp)[ok] for a in (k, t, j, vec))
    else:
        cg = np.arange(g)
        j = np.arange(cr)
        for name in ("pass1", "pass2"):
            kk, cc, jj = np.meshgrid(np.arange(nchunk), cg, j, indexing="ij")
            row = kk * cr + jj if name == "pass1" else np.minimum(rows, (kk + 1) * cr) - 1 - jj
            ok = row >= kk * cr if name == "pass2" else row < np.minimum(rows, (kk + 1) * cr)
            thread = cc % THREADS
            out[name] = (kk[ok], thread[ok], (jj * (-(-g // THREADS)) + cc // THREADS)[ok],
                         (row * g + cc)[ok])
    return plan, out


@pytest.mark.parametrize("shape,itemsize,aligned", PLAN_CASES, ids=PLAN_IDS)
def test_in_backward_plan_each_pass_covers_every_vector_once(shape, itemsize, aligned):
    plan, walks = _walks(shape, itemsize, aligned)
    assert plan["route"] == ("vector" if aligned else "scalar")
    assert plan["vec"] == (16 // itemsize if aligned else 1)
    assert plan["rows"] * plan["groups"] * plan["vec"] == math.prod(shape[1:])
    assert plan["blocks"] == shape[0] * plan["nchunk"]
    n = plan["rows"] * plan["groups"]
    for name, (_, _, _, vec) in walks.items():
        # each sample's base is b * spatial * C: the same walk in every sample
        counts = np.bincount(vec, minlength=n)
        assert counts.shape == (n,) and (counts == 1).all(), name


@pytest.mark.parametrize("shape,itemsize,aligned", PLAN_CASES, ids=PLAN_IDS)
def test_in_backward_plan_threads_keep_their_channels(shape, itemsize, aligned):
    """A thread's vectors are all of one column group, so its lanes meet
    the same channels ((group * vec + lane) % C) in every vector, and the
    table column it reads is right for each."""
    plan, walks = _walks(shape, itemsize, aligned)
    g, vec, c = plan["groups"], plan["vec"], shape[-1]
    for name, (chunk, thread, _, v) in walks.items():
        key = chunk * THREADS + thread
        order = np.argsort(key, kind="stable")
        key, grp = key[order], (v % g)[order]
        first = np.r_[True, key[1:] != key[:-1]]
        start = np.maximum.accumulate(np.where(first, np.arange(len(key)), 0))
        assert (grp == grp[start]).all(), name
        if g <= THREADS:
            assert (grp == thread[order] % g).all(), name
    lanes = (np.arange(g)[:, None] * vec + np.arange(vec)) % c
    elem = (np.arange(4)[:, None, None] * g + np.arange(g)[None, :, None]) * vec + np.arange(vec)
    assert (elem % c == lanes[None]).all()


@pytest.mark.parametrize("shape,itemsize,aligned", PLAN_CASES, ids=PLAN_IDS)
def test_in_backward_plan_pass_two_walks_pass_ones_chunks_backwards(shape, itemsize, aligned):
    """Block k of pass 2 owns exactly pass 1's chunk k; pass 1 walks it up
    from its first row, pass 2 down from its last, so pass 2's first loads
    are the rows pass 1 loaded last."""
    plan, walks = _walks(shape, itemsize, aligned)
    g, cr, rows = plan["groups"], plan["chunk_rows"], plan["rows"]
    c1, _, s1, v1 = walks["pass1"]
    c2, _, s2, v2 = walks["pass2"]
    for k in sorted({0, plan["nchunk"] // 2, plan["nchunk"] - 1}):
        row1, row2 = v1[c1 == k] // g, v2[c2 == k] // g
        step1, step2 = s1[c1 == k], s2[c2 == k]
        assert np.array_equal(np.unique(row1), np.unique(row2))
        assert np.array_equal(np.unique(row1), np.arange(k * cr, min(rows, (k + 1) * cr)))
        hi1 = [row1[step1 == s].max() for s in np.unique(step1)]
        hi2 = [row2[step2 == s].max() for s in np.unique(step2)]
        assert hi1 == sorted(hi1) and hi2 == sorted(hi2, reverse=True)
        last1 = set(row1[step1 == step1.max()])
        assert max(last1) in set(row2[step2 == 0])  # pass 2 starts where pass 1 ended
        assert row1[step1 == 0].min() in set(row2[step2 == step2.max()])


def _source_constants():
    src = open(SOURCE).read()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=lambda s: "x".join(map(str, s[1:])))
@pytest.mark.parametrize("itemsize", [2, 4])
def test_in_backward_plan_grid_fits_the_c_entry(shape, itemsize):
    """pmr_in_backward's checks, and the card's: B <= 65535, nchunk the
    chunks of rows that chunk_rows gives, C within the table, a sample
    under 2**31 elements; the grid one wave at four blocks an SM (the
    kernels' launch bounds), each pass's table under the 48 KB a block gets
    without opting in, and the fold's partials within STAT_FOLD_FLOATS."""
    const = _source_constants()
    assert (nm.BWD_BLOCKS_PER_SM, nm.BWD_MAX_CHANNELS, THREADS) == (
        const["kBwdMinBlocks"], const["kBwdMaxChannels"], const["kThreads"])
    b, c = shape[0], shape[-1]
    spatial = math.prod(shape[1:4])
    plan = nm.in_backward_plan(b, spatial, c, itemsize)
    assert 1 <= b <= 65535 and c <= nm.BWD_MAX_CHANNELS and spatial * c < 2 ** 31
    assert plan["chunk_rows"] >= 1 and plan["nchunk"] == -(-plan["rows"] // plan["chunk_rows"])
    assert plan["blocks"] <= nm.BWD_BLOCKS_PER_SM * nm.SMS
    assert plan["nchunk"] == 1 or 2 * c * plan["nchunk"] <= nm.STAT_FOLD_FLOATS
    table = plan["groups"] * plan["vec"] * 4  # a coefficient's column, max(C, vec) floats
    static = 2 * THREADS * plan["vec"] * 4  # pass 1's partial rows
    assert static + const["kBwdReduceCoefs"] * table <= 48 * 1024
    assert const["kBwdApplyCoefs"] * table <= 48 * 1024
    widest = const["kBwdApplyCoefs"] * nm.BWD_MAX_CHANNELS * 4
    assert widest <= 48 * 1024
    if spatial * c * itemsize >= 2 ** 23 and c <= 16:  # the level-0 shapes fill the wave
        assert plan["blocks"] == nm.BWD_BLOCKS_PER_SM * nm.SMS


def test_in_backward_plan_takes_rows_wider_than_a_block():
    """C = 300 bf16 takes the scalar route, 300 groups a row: thread tid
    walks groups tid and tid + 256 over every row, both passes once."""
    shape = (2, 3, 5, 7, 300)
    plan, walks = _walks(shape, 2, True)
    assert (plan["route"], plan["groups"]) == ("scalar", 300)
    for name, (_, _, _, vec) in walks.items():
        assert (np.bincount(vec, minlength=105 * 300) == 1).all(), name


@pytest.mark.parametrize("batch,spatial,c,itemsize", [
    (0, 8, 4, 2), (65536, 8, 4, 2), (2, 0, 4, 2), (2, 8, 0, 2), (2, 8, 4, 8),
    (1, 2 ** 28, 8, 2), (2, 8, 2049, 4), (2, 8, 4096, 2)])
def test_in_backward_plan_refuses_what_the_kernel_does_not_take(batch, spatial, c, itemsize):
    with pytest.raises(ValueError):
        nm.in_backward_plan(batch, spatial, c, itemsize)


def test_train_shapes_are_the_train_steps_k7_calls():
    import port_support

    calls = port_support.trace_model_calls(port_support.TRAIN_CFG, 2, torch.float32,
                                           head="train")
    shapes = sorted({sig[0] for name, sig in calls if name == "in_backward"})
    assert shapes == sorted(TRAIN_SHAPES)


def _replay(x, g, scale, bias, lrelu, dtype):
    """numpy replay of K7's arithmetic on fp32 values (x, g already in the
    dtype's values): the table's coefficients, pass 1's per-chunk partials
    (the second scaled by rstd) folded in chunk order in fp64, pass 2's dx =
    fma(kx, g', fma(p, x - mean, q)) rounded once to the dtype."""
    xt = torch.from_numpy(x).to(dtype)
    stats = nm.in_stats_plain(xt).numpy()
    b, c = x.shape[0], x.shape[-1]
    spatial = math.prod(x.shape[1:4])
    plan = nm.in_backward_plan(b, spatial, c, torch.finfo(dtype).bits // 8)
    xs, gs = x.reshape(b, spatial, c), g.reshape(b, spatial, c)
    f32 = np.float32
    mean, var = stats[:, 0], stats[:, 1]  # (B, C)
    rstd = (1 / np.sqrt(var.astype(np.float64) + 1e-3)).astype(f32)
    av = (rstd * scale).astype(f32)
    if dtype == torch.float32:
        a, cc, pre = av, np.broadcast_to(bias, av.shape), xs - mean[:, None]
    else:
        a = torch.from_numpy(av).bfloat16().float().numpy()
        cc = torch.from_numpy((bias - mean * av).astype(f32)).bfloat16().float().numpy()
        pre = xs
    neg = pre.astype(np.float64) * a[:, None] + cc[:, None] < 0
    gg = np.where(neg & lrelu, f32(0.1) * gs, gs).astype(f32)
    d = (xs - mean[:, None]).astype(f32)
    voxels = plan["chunk_rows"] * plan["groups"] * plan["vec"] // c  # a chunk's voxels
    edges = [min(spatial, k * voxels) for k in range(plan["nchunk"] + 1)]
    s1 = np.zeros((b, c), np.float64)
    s2 = np.zeros((b, c), np.float64)
    for lo, hi in zip(edges, edges[1:]):  # chunk partials, in order, added in fp64
        s1 += gg[:, lo:hi].sum(1, dtype=f32)
        s2 += (gg[:, lo:hi] * d[:, lo:hi]).sum(1, dtype=f32) * rstd
    s1, s2 = s1.astype(f32), s2.astype(f32)
    kx = (rstd * scale).astype(f32)
    p = (-kx * rstd * (s2 / f32(spatial))).astype(f32)
    q = (-kx * (s1 / f32(spatial))).astype(f32)
    inner = (p[:, None].astype(np.float64) * d + q[:, None]).astype(f32)
    dx = (kx[:, None].astype(np.float64) * gg + inner).astype(f32)
    return (torch.from_numpy(dx.reshape(x.shape)).to(dtype), np.stack([s1, s2], 1))


@pytest.mark.parametrize("lrelu", [False, True])
@pytest.mark.parametrize("c", [4, 16])
def test_k7_arithmetic_matches_jax_fp32(c, lrelu):
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 4, 10, 12, c)) * 2 + 0.5).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    scale = (1 + 0.3 * rng.normal(size=c)).astype(np.float32)
    bias = (0.3 * rng.normal(size=c)).astype(np.float32)
    dx, sums = _replay(x, g, scale, bias, lrelu, torch.float32)

    def jnorm(x_, s, b):
        y_ = jinstance_norm(x_, s, b)
        return jnp.where(y_ >= 0, y_, 0.1 * y_) if lrelu else y_

    _, vjp = jax.vjp(jnorm, *(jnp.asarray(a) for a in (x, scale, bias)))
    wx, ws, wb = (np.asarray(w) for w in vjp(jnp.asarray(g)))
    np.testing.assert_allclose(dx.numpy(), wx, atol=2e-5 * max(1, np.abs(wx).max()))
    np.testing.assert_allclose(sums[:, 1].sum(0), ws, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sums[:, 0].sum(0), wb, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("lrelu", [False, True])
@pytest.mark.parametrize("c", [8, 32])
def test_k7_arithmetic_matches_the_twin_bf16(c, lrelu):
    """bf16: the replay against K7's twin on the same bf16 values, at the
    card's bf16 tolerance (2**-6 of max(1, |ref|)), sums at 1e-4."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy((rng.normal(size=(2, 4, 10, 12, c)) * 2 + 0.5).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32))
    xb, gb = x.bfloat16(), g.bfloat16()
    scale = torch.from_numpy((1 + 0.3 * rng.normal(size=c)).astype(np.float32))
    bias = torch.from_numpy((0.3 * rng.normal(size=c)).astype(np.float32))
    dx, sums = _replay(xb.float().numpy(), gb.float().numpy(), scale.numpy(), bias.numpy(),
                       lrelu, torch.bfloat16)
    rdx, rsums = nm.in_backward(xb, gb, nm.in_stats(xb), scale, bias, lrelu)
    assert dx.dtype == rdx.dtype == torch.bfloat16
    err = ((dx.float() - rdx.float()).abs() / rdx.float().abs().clamp(min=1)).max()
    assert float(err) <= 2 ** -6
    np.testing.assert_allclose(sums, rsums.numpy(), rtol=1e-4, atol=1e-4)
