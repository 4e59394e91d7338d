"""K1/K2 on Hopper (csrc/conv3d_wgmma.cu), bf16 and fp32: a numpy replay
of the kernel's schedule, driven by the very host arrays the wrapper hands
the C entry, against the plain twins in float64; fp32 also in the kernel's
3xTF32 arithmetic; and the plan at every K1/K2 signature of the served
paths and of the train steps, in both dtypes.

The replay walks what the kernel walks: each block's tile and the origin
and extent of its input box, the producer's fill of each box stage (zeros
outside the input and past a part's channels) at the swizzled byte offsets,
each weight stage's layout (bf16 K1 MN-major, bf16 K2 and both fp32 roles
K-major, 128-byte swizzle; fp32 as hi and lo tiles), every wgmma step's
per-lane row addresses into the box (tap offset, swizzle), the B operand as
the wgmma descriptor reads it, parts, K2's phases, split ranges, fp32's
chain promotions and the ordered split-K sum. Tiny shapes, seconds.
"""

import collections
import functools
import itertools

import numpy as np
import pytest
import torch

from prostatemr_3d_cad_cspca_tpu_torch.ops import convolution as tconv
from prostatemr_3d_cad_cspca_tpu_torch.ops import cuda_lib

ATOL = 1e-9  # float64 sums of the same products in another order
DTYPES = (torch.bfloat16, torch.float32)


def _swizzle(byte, smask):
    return byte ^ (((byte >> 7) & smask) << 4)


def _pow2_at_least(n):
    return 1 << max(0, int(n) - 1).bit_length()


def _esize(dtype):
    return torch.empty((), dtype=dtype).element_size()


def _tf32(a):
    """cvt.rna.tf32.f32 on the int32 view: the magnitude rounded to 10
    mantissa bits, ties away from zero, the low 13 bits cleared."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a):
    """(hi, lo) of fp32 values as the kernel splits them (split_tf32)."""
    a = np.asarray(a, np.float32)
    hi = _tf32(a)
    return hi, _tf32(a - hi)


def _walk_slabs(meta, ntap, s0, s1, dtype):
    """(part, first channel, width, channel base, j0, j1) of each slab with
    weight stages [j0, j1) inside [s0, s1): walk_slabs of the kernel."""
    vec, kstage = 16 // _esize(dtype), tconv.WG_KSTAGE[dtype]
    out, g, ci_base = [], 0, 0
    for q in range(meta[0]):
        cin, wq, tma = int(meta[1 + q]), int(meta[7 + q]), (int(meta[13]) >> q) & 1
        for c0 in range(0, cin, wq):
            w = wq if tma else min(wq, max(vec, _pow2_at_least(cin - c0)))
            ns = -(-ntap * w // kstage)
            if g + ns > s0 and g < s1:
                out.append((q, c0, w, ci_base, max(0, s0 - g), min(ns, s1 - g)))
            g += ns
        ci_base += cin
    return out


def replay_wgmma(parts, kernel, bias, strides, transposed, dtype=torch.bfloat16,
                 arith="float64"):
    """The kernel's schedule on operands of ``dtype`` (numpy arrays of
    values that type holds): the output, and the plan. ``arith`` "float64"
    sums the exact products (the schedule); for fp32, "3xtf32" runs the
    kernel's arithmetic: each 8-deep step's A and B split into TF32 hi and
    lo, lo*hi + hi*lo + hi*hi into an fp32 chain added into the fp32 sums
    every WG_CHAIN_STAGES weight stages, fp32 partials; "tf32" the same with
    hi*hi alone."""
    assert arith == "float64" or dtype == torch.float32
    tparts = [torch.from_numpy(np.ascontiguousarray(p, np.float32)).to(dtype) for p in parts]
    tkernel = torch.from_numpy(np.ascontiguousarray(kernel, np.float32)).to(dtype)
    y, ws, plan, (ptrs, meta, taps) = tconv.wgmma_args(
        tparts, tkernel, None if bias is None else torch.from_numpy(bias), strides,
        transposed)
    assert ptrs.size == tconv.MAX_PARTS + 5 and meta.size == tconv.WG_META
    assert int(meta[98]) == 0  # one output
    assert (ws is None) == (meta[81] == 1) and int(meta[82]) == transposed
    assert int(meta[89]) == cuda_lib.DTYPE_CODES[dtype] and plan["dtype"] == dtype
    f32 = dtype == torch.float32
    esize = _esize(dtype)
    vec, kstage, kstep = 16 // esize, tconv.WG_KSTAGE[dtype], 32 // esize
    acc_t = np.float64 if arith == "float64" else np.float32
    xs = [p.astype(np.float64) for p in parts]
    wk = kernel.astype(np.float64).reshape(-1, *kernel.shape[3:])  # (tap, ., .)
    nparts, cin_total, batch = int(meta[0]), int(meta[15]), int(meta[16])
    ind, outd, grid = meta[17:20], meta[20:23], meta[23:26]
    cout, in_mul, in_add, out_mul = int(meta[26]), meta[27:30], meta[30:33], meta[33:36]
    lo, tile, box, tiles_ax = meta[36:39], meta[39:42], meta[42:45], meta[45:48]
    splits, bn = int(meta[81]), int(meta[83])
    a_stage, b_stage = int(meta[85]), int(meta[86])
    assert bn in tconv.WG_TILES_N[dtype]
    assert int(np.prod(tile)) == tconv.WG_ROWS and int(meta[88]) == plan["m_tiles"]
    assert int(meta[90]) == plan["grid"] == min(plan["units"], plan["wave"])
    assert plan["target"] == plan["wave"] * tconv.WG_SPLIT_WAVES[dtype]
    nslab = sum(len(sl) for sl in plan["slabs"])
    assert int(meta[95]) == plan["phase_loop"]
    if plan["phase_loop"]:  # every slab's box is a stage of its own, loaded once a unit
        assert int(meta[48]) > 1 and nslab <= plan["a_stages"]
        assert nslab == 1 or plan["splits"] == 1
    assert int(meta[92]) == plan["a_stages"] in range(2, 9)  # up to 8 beside resident weights
    assert plan["a_stages"] <= 4 or plan["resident"]
    assert plan["smem"] <= plan["budget"] <= tconv.WG_SMEM_BLOCK
    if f32:  # the hi and lo tiles of a stage, K-major
        assert b_stage == 2 * bn * 128
    # resident: every stage of every phase, converted once a block
    assert int(meta[96]) == plan["resident"] == (sum(plan["stages"]) if plan["resident"] else 0)
    assert int(meta[97]) == plan["raw_stages"]
    assert not plan["resident"] or (f32 and splits == 1 and plan["n_tiles"] == 1)
    if plan["flat"]:  # the kernel sees one row of batch x voxels
        xs = [x.reshape(1, 1, 1, -1, x.shape[-1]) for x in xs]
    box_vox = int(np.prod(box))
    m = np.arange(tconv.WG_ROWS)
    lx, ly, lz = m % tile[2], (m // tile[2]) % tile[1], m // (tile[2] * tile[1])
    rowvox = (lz * in_mul[0] * box[1] + ly * in_mul[1]) * box[2] + lx * in_mul[2]
    out_numel = int(np.prod(plan["out"]))
    partial = np.full((splits, out_numel), np.nan, acc_t)
    written = np.zeros((splits, out_numel), bool)
    for phase in range(int(meta[48])):
        ntap, res = int(meta[49 + phase]), meta[57 + 3 * phase:60 + 3 * phase]
        tp = taps[phase, :ntap].astype(np.int64)
        tapvox = np.append(((tp[:, 0] - lo[0]) * box[1] + tp[:, 1] - lo[1]) * box[2]
                           + tp[:, 2] - lo[2], 0)  # the padding tap reads voxel 0
        assert tapvox.min() >= 0 and (rowvox.max() + tapvox.max()) < box_vox
        nstage = sum(j1 - j0 for *_, j0, j1 in _walk_slabs(meta, ntap, 0, 1 << 30, dtype))
        assert nstage == plan["stages"][phase]
        for split, mt, nt in itertools.product(range(splits), range(plan["m_tiles"]),
                                               range(plan["n_tiles"])):
            s0, s1 = nstage * split // splits, nstage * (split + 1) // splits
            assert (s0, s1) == plan["ranges"][phase][split] and s0 < s1
            t = mt
            tx, t = t % tiles_ax[2], t // tiles_ax[2]
            ty, t = t % tiles_ax[1], t // tiles_ax[1]
            tz, b = t % tiles_ax[0], t // tiles_ax[0]
            g0 = np.array([tz, ty, tx]) * tile
            origin = g0 * in_mul + in_add + lo
            n0 = nt * bn
            acc = np.zeros((tconv.WG_ROWS, bn), acc_t)
            chain = np.zeros((tconv.WG_ROWS, bn), np.float32)
            nst = 0
            for q, c0, w, ci_base, j0, j1 in _walk_slabs(meta, ntap, s0, s1, dtype):
                cin, smask, lw = int(meta[1 + q]), w // vec - 1, w.bit_length() - 1
                assert box_vox * esize * w <= a_stage
                # the producer: the box of (part q, channels [c0, c0 + w))
                smem = np.full(a_stage // esize, np.nan)
                v, c, e = np.meshgrid(np.arange(box_vox), np.arange(w // vec), np.arange(vec),
                                      indexing="ij")
                bz, by, bx = v // (box[1] * box[2]), (v // box[2]) % box[1], v % box[2]
                coords = [origin[0] + bz, origin[1] + by, origin[2] + bx]
                ch = c0 + c * vec + e
                ok = (ch < cin) & np.logical_and.reduce(
                    [(cc >= 0) & (cc < n) for cc, n in zip(coords, ind)])
                vals = xs[q][b, *[np.clip(cc, 0, n - 1) for cc, n in zip(coords, ind)],
                             np.minimum(ch, cin - 1)]
                smem[(_swizzle(v * esize * w + c * 16, smask) + esize * e) // esize] = \
                    np.where(ok, vals, 0)
                for j in range(j0, j1):
                    bst = np.full(b_stage // esize, np.nan)
                    if transposed or f32:  # K-major: row n of kstage k in 16-byte chunks kc
                        n, kc, e = np.meshgrid(np.arange(bn), np.arange(8), np.arange(vec),
                                               indexing="ij")
                        k = j * kstage + kc * vec + e
                        tt, chb = k >> lw, c0 + (k & (w - 1))
                        co = n0 + n
                        ok = (tt < ntap) & (co < cout) & (chb < cin)
                        wt = tp[np.minimum(tt, ntap - 1), 3]
                        ci = np.minimum(ci_base + chb, cin_total - 1)
                        com = np.minimum(co, cout - 1)
                        vals = wk[wt, com, ci] if transposed else wk[wt, ci, com]
                        byte = n * 128 + ((kc ^ (n & 7)) << 4) + esize * e
                    else:  # bf16 K1, MN-major: row r (k), 64-n groups of 8-n chunks cc
                        r, cc, e = np.meshgrid(np.arange(64), np.arange(bn // 8), np.arange(8),
                                               indexing="ij")
                        k = j * 64 + r
                        tt, chb = k >> lw, c0 + (k & (w - 1))
                        co = n0 + cc * 8 + e
                        ok = (tt < ntap) & (chb < cin) & (co < cout)
                        wt = tp[np.minimum(tt, ntap - 1), 3]
                        vals = wk[wt, np.minimum(ci_base + chb, cin_total - 1),
                                  np.minimum(co, cout - 1)]
                        byte = (cc >> 3) * 8192 + r * 128 + (((cc & 7) ^ (r & 7)) << 4) + 2 * e
                    assert byte.max() < (b_stage // 2 if f32 else b_stage)
                    bst[byte // esize] = np.where(ok, vals, 0)
                    if f32:  # the lo tile follows the hi one
                        hi, low = _split(bst[:b_stage // 8])
                        assert not np.isnan(bst[:b_stage // 8]).any()
                    # the consumers: the stage's wgmma steps
                    for s in range(min(4, -(-(ntap * w - j * kstage) // kstep))):
                        a = np.empty((tconv.WG_ROWS, kstep))
                        for h in range(2):  # lanes 0-15 and 16-31: the step's two 16-byte halves
                            k = j * kstage + s * kstep + h * vec
                            byte = (rowvox + tapvox[k >> lw]) * esize * w + \
                                ((k & (w - 1)) // vec) * 16
                            phys = _swizzle(byte, smask)
                            assert phys.max() + 16 <= a_stage
                            a[:, vec * h:vec * h + vec] = smem[phys[:, None] // esize
                                                               + np.arange(vec)]
                        kk, n = np.meshgrid(np.arange(kstep), np.arange(bn), indexing="ij")
                        if transposed or f32:  # K-major: the descriptor starts 32 s bytes on
                            kq = s * kstep + kk
                            byte = n * 128 + (((kq // vec) ^ (n & 7)) << 4) + (kq % vec) * esize
                        else:  # MN-major with trans-b: 16 rows (2048 bytes) a step
                            r = s * 16 + kk
                            byte = ((n >> 6) * 8192 + r * 128 + ((((n & 63) >> 3) ^ (r & 7)) << 4)
                                    + (n & 7) * 2)
                        bmat = bst[byte // esize]
                        assert not np.isnan(a).any() and not np.isnan(bmat).any()
                        if arith == "float64":
                            acc += a @ bmat
                            continue
                        ahi, alo = _split(a)
                        bhi, blo = hi[byte // esize], low[byte // esize]
                        terms = [(alo, bhi), (ahi, blo), (ahi, bhi)] if arith == "3xtf32" \
                            else [(ahi, bhi)]
                        for x, wgt in terms:  # lo*hi, hi*lo, hi*hi
                            chain += x @ wgt
                    nst += 1
                    if arith != "float64" and nst % tconv.WG_CHAIN_STAGES == 0:
                        acc += chain  # the chain into the fp32 sums
                        chain[:] = 0
            if arith != "float64":
                acc += chain
            # the epilogue's rows and columns
            g = g0[:, None] + np.stack([lz, ly, lx])
            rows = np.all(g < grid[:, None], axis=0)
            o = g * out_mul[:, None] + res[:, None]
            ofs = (((b * outd[0] + o[0]) * outd[1] + o[1]) * outd[2] + o[2]) * cout
            cols = n0 + np.arange(bn) < cout
            idx = ofs[rows][:, None] + (n0 + np.arange(bn))[cols][None, :]
            assert not written[split, idx].any()
            partial[split, idx] = acc[rows][:, cols]
            written[split, idx] = True
    assert written.all(), "some output element belongs to no tile"
    total = partial[0].copy()
    for j in range(1, splits):  # the reduce kernel's order
        total += partial[j]
    if bias is not None:
        total += np.tile(bias.astype(acc_t), out_numel // cout)
    return total.reshape(plan["out"]), plan


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _as(dtype, a):
    """The values of ``a`` that ``dtype`` holds, as float32."""
    a = np.ascontiguousarray(a, np.float32)
    return _bf16(a) if dtype == torch.bfloat16 else a


def _case(seed, spatial, widths, ks, cout, transposed, batch=1, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    parts = [_as(dtype, rng.normal(size=(batch, *spatial, c))) for c in widths]
    kshape = (*ks, cout, widths[0]) if transposed else (*ks, sum(widths), cout)
    kernel = _as(dtype, rng.normal(size=kshape) / np.sqrt(np.prod(ks) * sum(widths)))
    bias = (0.1 * rng.normal(size=(cout,))).astype(np.float32)
    return parts, kernel, bias


def _plain(parts, kernel, bias, strides, transposed):
    t = [torch.from_numpy(p).double() for p in parts]
    k, bb = torch.from_numpy(kernel).double(), torch.from_numpy(bias).double()
    if transposed:
        return tconv.conv3d_transpose_plain(t[0], k, bb, strides).numpy()
    return tconv.conv3d_plain(t, k, bb, strides).numpy()


# (spatial, part widths, kernel, strides, cout, transposed): the stem's 3
# channels, level 0's 4, an odd width (19) beside an aligned part, six
# parts, strides (1,2,2) and (2,2,2), 1x1x1 (flat), K2 at both strides and at
# an odd width, a wide cout (two 64-wide weight groups)
REPLAY_CASES = [
    ((3, 9, 20), (3,), (1, 3, 3), (1, 1, 1), 16, False),
    ((4, 6, 10), (4,), (3, 3, 3), (1, 1, 1), 4, False),
    ((3, 7, 9), (19, 16), (3, 3, 3), (1, 2, 2), 8, False),
    ((2, 5, 12), (16, 8, 16, 3, 8, 4), (1, 3, 3), (1, 1, 1), 6, False),
    ((5, 6, 7), (16,), (3, 3, 3), (2, 2, 2), 24, False),
    ((3, 5, 30), (64, 3), (1, 1, 1), (1, 1, 1), 96, False),
    ((3, 4, 5), (64,), (3, 3, 3), (2, 2, 2), 16, True),
    ((2, 4, 6), (19,), (1, 3, 3), (1, 2, 2), 8, True),
    ((2, 3, 4), (130,), (3, 3, 3), (2, 2, 2), 12, True),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spatial,widths,ks,st,cout,transposed", REPLAY_CASES)
def test_replay_matches_the_plain_conv(spatial, widths, ks, st, cout, transposed, dtype):
    parts, kernel, bias = _case(hash((spatial, widths, ks, st)) % 2 ** 32, spatial, widths,
                                ks, cout, transposed, dtype=dtype)
    got, plan = replay_wgmma(parts, kernel, bias, st, transposed, dtype)
    np.testing.assert_allclose(got, _plain(parts, kernel, bias, st, transposed), atol=ATOL)
    assert plan["tma"] == [w % (16 // _esize(dtype)) == 0 for w in widths]
    assert plan["flat"] == (ks == (1, 1, 1) and st == (1, 1, 1))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("transposed", [False, True])
def test_replay_with_split_k(transposed, dtype, monkeypatch):
    """K split as finely as the plan allows (one weight stage a split in the
    shortest phase): the partials and their ordered sum."""
    monkeypatch.setattr(tconv, "WG_MIN_STAGES_PER_SPLIT", 1)
    tconv._wgmma_host.cache_clear()
    try:
        spatial, widths, ks, st = ((3, 4, 6), (64,), (3, 3, 3), (1, 2, 2)) if transposed \
            else ((3, 4, 6), (32, 8), (3, 3, 3), (1, 1, 1))
        parts, kernel, bias = _case(7 + transposed, spatial, widths, ks, 8, transposed,
                                    dtype=dtype)
        got, plan = replay_wgmma(parts, kernel, bias, st, transposed, dtype)
        assert plan["splits"] == min(plan["stages"]) > 1
        np.testing.assert_allclose(got, _plain(parts, kernel, bias, st, transposed),
                                   atol=ATOL)
    finally:
        tconv._wgmma_host.cache_clear()


@pytest.mark.parametrize("dtype", DTYPES)
def test_swizzle_keeps_eight_rows_of_a_chunk_in_distinct_banks(dtype):
    """ldmatrix reads 8 rows of 16 bytes a phase: at every slab width the
    swizzled chunks of 8 consecutive voxels fall in 8 distinct 16-byte bank
    groups (128 bytes of banks)."""
    vec = 16 // _esize(dtype)
    for w in tconv.WG_SLAB_WIDTHS[dtype]:
        row = w * _esize(dtype)
        for v0, c in itertools.product(range(0, 64, 8), range(w // vec)):
            phys = [_swizzle((v0 + v) * row + c * 16, w // vec - 1) for v in range(8)]
            assert len({(p >> 4) & 7 for p in phys}) == 8, (w, v0, c)


# --------------------------------------------- fp32: slabs and routes
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("cin", [3, 4, 5, 65])
def test_fp32_slabs_and_routes(cin, aligned):
    """An fp32 part goes by TMA where its channels make a 16-byte voxel
    stride (a multiple of 4: level 0's 4, which bf16 cannot) and its base is
    16-byte aligned, else staged; a staged part's last slab narrows to the
    least power of two of at least 4 that holds what is left (the stem's 3
    and the six-part ladder's 5 take 4 and 8, the ladder's 65 a 32-wide
    slab, a 32-wide one and a 4-wide one). The weights take 16-byte loads
    where their last axis is a multiple of 4 and aligned."""
    flat = torch.zeros(2 * 3 * 4 * 5 * cin + 1)
    x = (flat[:-1] if aligned else flat[1:]).view(2, 3, 4, 5, cin)
    assert (x.data_ptr() % 16 == 0) == aligned
    k1 = torch.zeros(3, 3, 3, cin, 8)
    _, _, plan, (_, meta, _) = tconv.wgmma_args([x], k1, None, (1, 1, 1), False)
    tma = cin % 4 == 0 and aligned
    assert plan["tma"] == [tma] and int(meta[13]) == tma
    width = plan["widths"][0]
    assert width == min(32, max(4, _pow2_at_least(cin)))
    want = [(c0, width if tma else min(width, max(4, _pow2_at_least(cin - c0))))
            for c0 in range(0, cin, width)]
    assert plan["slabs"] == [want]
    assert {65: [(0, 32), (32, 32), (64, 4)], 5: [(0, 8)], 3: [(0, 4)]}.get(cin, want) == want
    assert plan["stages"] == (sum(-(-27 * w // 32) for _, w in want),)
    assert int(meta[14]) == 1  # cout 8: 16-byte weight chunks
    k2 = torch.zeros(3, 3, 3, 8, cin)  # K2's (.., Cout, Cin): 16-byte loads along cin
    _, _, _, (_, meta2, _) = tconv.wgmma_args([x], k2, None, (1, 2, 2), True)
    assert int(meta2[14]) == (cin % 4 == 0)


# ------------------------------------------------------------- the plans
@functools.lru_cache(maxsize=None)
def _signatures(dtype):
    """Every K1/K2 signature in ``dtype`` of the served paths' forwards
    (cfg1, cfg2, the probabilistic ladder, its dense-skip form, the cascade)
    at batch 2, 8 and 16, and of the train step at batch 2 (its data
    gradients)."""
    import port_support as ps

    sigs = collections.Counter()
    for batch in (2, 8, 16):
        sigs.update(ps.trace_path_calls(batch, dtype))
    for cfg in (ps.CFG2, ps.PROB, ps.PROB_DENSE, ps.CASCADE):
        sigs.update(ps.trace_model_calls(cfg, 2, dtype, head="forward"))
    sigs.update(ps.trace_model_calls(ps.TRAIN_CFG, 2, dtype, head="train"))
    # a K1 pair's signature holds its whole kernel: a K1 plan like any other
    return sorted({k for k in sigs if k[0] in ("conv3d", "conv3d_pair", "conv3d_transpose")},
                  key=str)


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_path_signature_has_a_plan_that_fits(dtype):
    """Each plan fits the block's shared memory (227 KB, or its share of an
    SM's at two blocks), takes TMA only where it is legal (16-byte voxel
    strides and box extents TMA takes), keeps the kernel's indices in int32
    and fills no more than the card's wave with split-K."""
    sigs = _signatures(dtype)
    esize = _esize(dtype)
    vec = 16 // esize
    assert any(n == "conv3d_transpose" and s[0][-1] == 259 for n, s in sigs)
    for name, sig in sigs:
        transposed = name == "conv3d_transpose"
        shapes = [sig[0]] if transposed else list(sig[0])
        plan = tconv.wgmma_plan(shapes, sig[1], sig[2], transposed, dtype=dtype)
        assert plan["smem"] <= plan["budget"] <= tconv.WG_SMEM_BLOCK, (name, sig)
        assert plan["budget"] * tconv.WG_RESIDENT[dtype][plan["bn"]] <= tconv.WG_SMEM_SM
        assert plan["a_stage"] >= plan["box_vox"] * plan["width"] * esize
        assert plan["smem"] == tconv._wgmma_smem(plan["box_vox"], plan["width"], plan["bn"],
                                                 transposed, plan["a_stages"], dtype,
                                                 plan["resident"], plan["raw_stages"])[2]
        assert 3 <= plan["raw_stages"] <= 8
        for s, tma, w in zip(shapes, plan["tma"], plan["widths"]):
            assert tma == (s[-1] % vec == 0), (name, sig)  # TMA needs 16-byte voxel strides
            assert w in tconv.WG_SLAB_WIDTHS[dtype] and w <= max(vec, _pow2_at_least(s[-1]))
        assert max(plan["box"]) <= tconv.WG_BOX_MAX
        rows = plan["view"]["batch"] * int(np.prod(plan["view"]["ind"]))
        assert max(rows * max(s[-1] for s in shapes), int(np.prod(plan["out"])),
                   plan["workspace"], plan["m_tiles"] * tconv.WG_ROWS) < tconv.MAX_INDEX
        assert all(lo < hi for r in plan["ranges"] for lo, hi in r)
        if plan["splits"] > 1:
            assert plan["blocks"] <= plan["target"], (name, sig)


@pytest.mark.parametrize("dtype", DTYPES)
def test_host_arrays_are_built_once_per_signature(dtype):
    """A call reuses the cached meta and taps; only its pointers are new."""
    x = torch.zeros(1, 2, 4, 8, 16, dtype=dtype)
    k = torch.zeros(1, 3, 3, 16, 8, dtype=dtype)
    first = tconv.wgmma_args([x], k, None, (1, 1, 1), False)
    again = tconv.wgmma_args([x.clone()], k.clone(), None, (1, 1, 1), False)
    assert first[3][1] is again[3][1] and first[3][2] is again[3][2]
    assert not first[3][1].flags.writeable
    assert first[3][0][0] != again[3][0][0]
    assert int(first[3][1][89]) == cuda_lib.DTYPE_CODES[dtype]


def test_both_dtypes_route_to_wgmma():
    """One K1/K2 kernel serves fp32 and bf16; any other dtype is refused."""
    for dtype in DTYPES:
        assert tconv.wgmma_plan([(2, 4, 8, 8, 16)], (3, 3, 3, 16, 8), (1, 1, 1), False,
                                dtype=dtype)["splits"] >= 1
    with pytest.raises(TypeError):
        tconv.wgmma_plan([(2, 4, 8, 8, 16)], (3, 3, 3, 16, 8), (1, 1, 1), False,
                         dtype=torch.float16)
