"""K6 ``conv3d_wgrad`` on Hopper (csrc/conv3d_wgrad.cu), bf16 and fp32: a
numpy replay of the kernel's schedule, driven by the very geometry array the
wrapper hands the C entry (``convolution.wgrad_args``).

The replay walks what the kernel walks: each block's taps, slab and channel
tile and its split's boxes; the producer's fill of each stage (A's halo box
and B's box at the swizzled offsets TMA or the staged route write, zeros
outside the grids and past the channels); the consumers' conversion of B
into K-major tiles (bf16: ldmatrix .trans then stmatrix, lane by lane; fp32:
4 x 4 blocks split into hi and lo); every wgmma step's per-lane A addresses
(voxel row, tap shift, swizzle) and the B operand as the descriptor reads
it; fp32's chain added once a box; the splits' ordered reduce; the
epilogue's rows. Checked:

  * the constants and the geometry array against the kernel's source;
  * the boxes cover every output voxel once, every tap's rows lie inside the
    halo box (K2's stride-2 windows too), the blocks' rows cover M once;
  * the staged route's box rows equal the gathered window;
  * the replay in exact arithmetic is the weight gradient: the fp64 twin at
    1e-10 of the output's largest |value| and ``jax.grad`` of the
    convolution at the fp32 oracle tolerance (2e-5);
  * the replay in the kernel's fp32 arithmetic (3xTF32 into chains added
    once a box, the ordered reduce) holds the card's fp32 limit, |diff| /
    max(1, |ref|) <= 2e-4 of the fp64 product, at a level-0-like shape of
    65,536 rows; TF32 alone does not;
  * the plan fits the card at every K6 shape of a cfg1 train step.
"""

import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prostatemr_3d_cad_cspca_tpu_torch.ops import convolution as cv
from test_torch_conv_halo import _swizzle

FP32_LIMIT = 2e-4  # chip_smoke.FP32_LIMIT
DN = ("NDHWC", "DHWIO", "NDHWC")
DTYPES = (torch.bfloat16, torch.float32)
SRC = os.path.join(os.path.dirname(cv.__file__), "..", "csrc", "conv3d_wgrad.cu")
# the geometry array's fields as pmr_conv3d_wgrad reads them (index: field)
FIELDS = {"a_d": 0, "a_h": 1, "a_w": 2, "ca": 3, "o_d": 4, "o_h": 5, "o_w": 6, "cb": 7,
          "kd": 8, "kh": 9, "kw": 10, "st": 11, "lo": 14, "batch": 17, "tile": 18, "box": 21,
          "tiles_ax": 24, "width": 27, "tpb": 28, "tap_groups": 29, "slabs": 30, "bn": 31,
          "n_tiles": 32, "splits": 33, "nbox": 34, "a_tma": 35, "b_tma": 36, "a_stage": 37,
          "b_stage": 38, "stages": 39, "smem": 40, "ntaps": 41, "pingpong": 42, "a_parts": 43,
          "b_parts": 44}
TRIPLES = ("st", "lo", "tile", "box", "tiles_ax")
# K1's and K2's weight-gradient roles at small sizes: (A's shape, kernel,
# strides, CB). The stem's 3 channels and bf16's 4 and 12 take the staged
# route; CB 1, 2 and bf16's 4 too; (1,2,2) and (2,2,2) are K2's roles.
CASES = [((2, 5, 9, 10, 3), (1, 3, 3), (1, 1, 1), 16),
         ((2, 5, 9, 10, 16), (1, 3, 3), (1, 2, 2), 4),
         ((2, 6, 8, 10, 12), (3, 3, 3), (2, 2, 2), 70),
         ((1, 3, 4, 4, 64), (3, 3, 3), (1, 1, 1), 128),
         ((2, 4, 6, 6, 4), (3, 3, 3), (1, 1, 1), 1),
         ((2, 8, 24, 24, 16), (1, 1, 1), (1, 1, 1), 2),
         ((2, 4, 12, 20, 32), (1, 3, 3), (1, 1, 1), 32),
         ((1, 6, 12, 12, 40), (3, 3, 3), (1, 2, 2), 16)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(rng, ashape, ks, st, cb):
    a = rng.normal(size=ashape).astype(np.float32)
    out = [cv.same_pads(n, k, s)[0] for n, k, s in zip(ashape[1:4], ks, st)]
    b = rng.normal(size=(ashape[0], *out, cb)).astype(np.float32)
    return a, b


def _geom(geom):
    """The geometry array as the C entry unpacks it (FIELDS)."""
    g = [int(x) for x in geom]
    return {k: (g[i:i + 3] if k in TRIPLES else g[i]) for k, i in FIELDS.items()}


def _args(a, b, ks, st, dtype):
    ta, tb = _t(a).to(dtype), _t(b).to(dtype)
    out, ws, plan, geom = cv.wgrad_args(ta, tb, ks, st)
    return ta, tb, out, ws, plan, _geom(geom)


def _log2(n):
    return int(n).bit_length() - 1


def _boxes(g):
    """(sample, oz, oy, ox) of every box q, as box_of decodes it."""
    q = np.arange(g["nbox"])
    t0, t1, t2 = g["tiles_ax"]
    tx, q = q % t2, q // t2
    ty, q = q % t1, q // t1
    tz, bq = q % t0, q // t0
    return bq, tz * g["tile"][0], ty * g["tile"][1], tx * g["tile"][2]


def _tile_voxel(g, k):
    """(z, y, x) in the tile of a box's voxel k, by the kernel's shifts."""
    ltw, lth = _log2(g["tile"][2]), _log2(g["tile"][1])
    return k >> (ltw + lth), (k >> ltw) & (g["tile"][1] - 1), k & (g["tile"][2] - 1)


def _rowvox(g, k):
    z, y, x = _tile_voxel(g, k)
    st, box = g["st"], g["box"]
    return z * st[0] * box[1] * box[2] + y * st[1] * box[2] + x * st[2]


def _tapvox(g):
    t = np.arange(g["ntaps"])
    dx, dy, dz = t % g["kw"], (t // g["kw"]) % g["kh"], t // (g["kw"] * g["kh"])
    return (dz * g["box"][1] + dy) * g["box"][2] + dx


def _units(g):
    """(t0, ntb, ca0, n0, split, bx0, bx1) of every block, as unit_of."""
    out = []
    for u in range(g["tap_groups"] * g["slabs"] * g["n_tiles"] * g["splits"]):
        tg, r = u % g["tap_groups"], u // g["tap_groups"]
        slab, r = r % g["slabs"], r // g["slabs"]
        nt, split = r % g["n_tiles"], r // g["n_tiles"]
        t0 = tg * g["tpb"]
        out.append((t0, min(g["tpb"], g["ntaps"] - t0), slab * g["width"], nt * g["bn"], split,
                    g["nbox"] * split // g["splits"], g["nbox"] * (split + 1) // g["splits"]))
    return out


def _views(av, bv, g):
    """A and B in the kernel's view (flat: one sample, one row of voxels)."""
    return (av.reshape(g["batch"], g["a_d"], g["a_h"], g["a_w"], g["ca"]),
            bv.reshape(g["batch"], g["o_d"], g["o_h"], g["o_w"], g["cb"]))


def _fill_a(av, g, ca0, esize):
    """Each box's A stage as the producer fills it (TMA or staged: the same
    bytes): element (voxel v, channel c) of the slab at its swizzled
    offset; zeros outside A and past its channels. Shape (nbox, box voxels x
    width)."""
    bq, oz, oy, ox = _boxes(g)
    w, box = g["width"], g["box"]
    v = np.arange(math.prod(box))
    x, yz = v % box[2], v // box[2]
    z, y = yz // box[1], yz % box[1]
    gz = (oz * g["st"][0] - g["lo"][0])[:, None] + z
    gy = (oy * g["st"][1] - g["lo"][1])[:, None] + y
    gx = (ox * g["st"][2] - g["lo"][2])[:, None] + x
    inside = ((gz >= 0) & (gz < g["a_d"]) & (gy >= 0) & (gy < g["a_h"]) & (gx >= 0)
              & (gx < g["a_w"]))
    pad = np.zeros((*av.shape[:4], ca0 + w), av.dtype)
    keep = min(g["ca"], ca0 + w)
    pad[..., :keep] = av[..., :keep]
    vals = pad[bq[:, None], np.clip(gz, 0, g["a_d"] - 1), np.clip(gy, 0, g["a_h"] - 1),
               np.clip(gx, 0, g["a_w"] - 1)][..., ca0:ca0 + w]
    vals = np.where(inside[..., None], vals, 0)
    pitch, amask = w * esize, w * esize // 16 - 1
    c = np.arange(w)
    pos = _swizzle(v[:, None] * pitch + c[None] * esize, amask) // esize
    stage = np.zeros((len(bq), v.size * w), av.dtype)
    stage[:, pos.reshape(-1)] = vals.reshape(len(bq), -1)
    return stage


def _convert_a(stage, g):
    """fp32: the consumers' part box of each box's A stage, in bf16's layout
    (2 x width bytes a voxel, its swizzle): 8 channels of a voxel a thread,
    two 16-byte chunks of the fp32 box into one of each part box. The
    replay carries the value itself (its parts are the same elements'
    splits)."""
    w, vox = g["width"], math.prod(g["box"])
    amask, cmask = w * 4 // 16 - 1, w * 2 // 16 - 1
    it = np.arange(vox * (w // 8))
    v, c8 = it // (w // 8), it % (w // 8)
    e = np.arange(8)
    src = np.concatenate([_swizzle(v * w * 4 + c8 * 32, amask)[:, None] // 4 + e[None, :4],
                          _swizzle(v * w * 4 + c8 * 32 + 16, amask)[:, None] // 4 + e[None, :4]],
                         axis=1)
    dst = _swizzle(v * w * 2 + c8 * 16, cmask)[:, None] // 2 + e[None]
    assert np.array_equal(np.sort(dst.reshape(-1)), np.arange(vox * w))
    out = np.zeros_like(stage)
    out[:, dst.reshape(-1)] = stage[:, src.reshape(-1)]
    return out


def _a_rows(stage, g, t0, ntb, tapvox):
    """Each box's A rows (the block's live tiles x 128 voxels) as the
    consumers' ldmatrix reads them from a bf16-layout box (bf16's A stage,
    fp32's part box): a lane's 16-byte row is 8 channels of one tap."""
    w = g["width"]
    rows = -(-ntb * w // 64) * 64
    r = np.arange(rows)
    tl = r >> _log2(w)
    tv = np.where(tl < ntb, tapvox[np.minimum(t0 + tl, g["ntaps"] - 1)], 0)
    k = np.arange(cv.WGRAD_BOX)
    pitch, amask = w * 2, w * 2 // 16 - 1
    r8 = r & ~7
    byte = (_rowvox(g, k)[None] + tv[r8][:, None]) * pitch + ((r8 % w) * 2)[:, None]
    pos = _swizzle(byte, amask) // 2 + (r & 7)[:, None]
    assert pos.min() >= 0 and pos.max() < math.prod(g["box"]) * w  # inside the box
    return stage[:, pos]  # (nbox, rows, 128)


def _b_tile(bv, g, n0, esize):
    """Each box's B as the wgmma descriptor reads it, (nbox, 128 voxels,
    bn): the raw box as TMA or the staged route lands it (groups of kBW
    channels, swizzled rows), converted lane by lane as the consumers do."""
    bn, box = g["bn"], cv.WGRAD_BOX
    kbw = bn if bn * esize <= 128 else 128 // esize
    bmask = kbw * esize // 16 - 1
    bq, oz, oy, ox = _boxes(g)
    k = np.arange(box)
    z, y, x = _tile_voxel(g, k)
    gz, gy, gx = oz[:, None] + z, oy[:, None] + y, ox[:, None] + x
    inside = (gz < g["o_d"]) & (gy < g["o_h"]) & (gx < g["o_w"])
    pad = np.zeros((*bv.shape[:4], n0 + bn), bv.dtype)
    keep = min(g["cb"], n0 + bn)
    pad[..., :keep] = bv[..., :keep]
    vals = pad[bq[:, None], np.minimum(gz, g["o_d"] - 1), np.minimum(gy, g["o_h"] - 1),
               np.minimum(gx, g["o_w"] - 1)][..., n0:n0 + bn]
    vals = np.where(inside[..., None], vals, 0)
    c = np.arange(bn)
    raw_pos = ((c // kbw) * box * kbw)[None] + _swizzle(
        k[:, None] * kbw * esize + (c % kbw)[None] * esize, bmask) // esize
    raw = np.zeros((len(bq), box * bn), bv.dtype)
    raw[:, raw_pos.reshape(-1)] = vals.reshape(len(bq), -1)
    rows = 3 * bn if esize == 4 else bn  # a 64-voxel tile's rows: the parts' bn each
    if esize == 4:
        # fp32: 4 channels of a voxel a thread into each part's bf16 rows of
        # bn (their own swizzle); the replay carries the value in part 0
        pmask = bn * 2 // 16 - 1
        it = np.arange(box * (bn // 4))
        kq, c4 = it // (bn // 4), it % (bn // 4)
        e = np.arange(4)
        src = _swizzle(kq * bn * 4 + c4 * 16, bmask)[:, None] // 4 + e
        dst = _swizzle(kq * bn * 2 + c4 * 8, pmask)[:, None] // 2 + e
        assert np.array_equal(np.sort(dst.reshape(-1)), np.arange(box * bn))
        raw16 = np.zeros_like(raw)
        raw16[:, dst.reshape(-1)] = raw[:, src.reshape(-1)]
        raw, kbw, bmask, parts = raw16, bn, pmask, 3
    else:
        parts = 1
    # each part's quads of 8 x 8 blocks: ldmatrix .trans, then stmatrix
    src, dst = [], []
    for q in range(parts):
        for qd in range(bn // 2):
            n8 = (qd >> 2) * 8
            for j in range(4):
                kk = ((qd & 3) * 4 + j) * 8
                for gg in range(8):
                    n = q * bn + n8 + gg
                    d0 = (kk // 64) * rows * 64 + n * 64 + ((((kk % 64) >> 3) ^ (n & 7)) * 8)
                    for cc in range(8):  # tile[dst(8j + gg) + cc] = raw[src(8j + cc) + gg]
                        s0 = (n8 // kbw) * box * kbw + _swizzle(
                            (kk + cc) * kbw * 2 + (n8 % kbw) * 2, bmask) // 2
                        src.append(s0 + gg if q == 0 else -1)
                        dst.append(d0 + cc)
    src, dst = np.array(src), np.array(dst)
    assert np.array_equal(np.sort(dst), np.arange(box * rows))  # each tile element once
    tile = np.zeros((len(bq), box * rows), bv.dtype)
    tile[:, dst[src >= 0]] = raw[:, src[src >= 0]]
    # the descriptor's K-major read of part 0: row n, k's 16-byte chunk XOR (row & 7)
    kk, n = np.meshgrid(np.arange(box), np.arange(bn), indexing="ij")
    pos = (kk // 64) * rows * 64 + n * 64 + (((kk % 64) // 8) ^ (n & 7)) * 8 + kk % 8
    return tile[:, pos]


def _reduce(parts):
    """wgrad_reduce_kernel's order: group g sums splits g, g + 8, ... in
    order, then the groups in order."""
    groups = cv.WGRAD_REDUCE_GROUPS
    sums = []
    for g in range(min(groups, len(parts))):
        s = parts[g].copy()
        for j in range(g + groups, len(parts), groups):
            s += parts[j]
        sums.append(s)
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    return total


def _bf16(x):
    """Round to bf16, nearest even (__float2bfloat16_rn), as fp32 values."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _parts(x):
    """split_bf16x3: x1 = bf16(x), x2 = bf16(x - x1), x3 = bf16(x - x1 - x2)."""
    x = np.asarray(x, np.float32)
    x1 = _bf16(x)
    r1 = x - x1
    x2 = _bf16(r1)
    return x1, x2, _bf16(r1 - x2)


def replay_wgrad(a, b, ks, st, dtype, arith="float64"):
    """numpy replay of csrc/conv3d_wgrad.cu in ``dtype`` from the geometry
    the wrapper packs. The operands are rounded to ``dtype``; "float64"
    sums exactly, which checks the schedule; "bf16x3" (fp32) runs the
    kernel's arithmetic: A and B in three bf16 parts, each k16 step's
    a1 . [b1 | b2 | b3], a2 . [b1 | b2] and a3 . b1 into a chain of three
    column blocks in fp32, added into fp32 sums once a box (block 0 plus
    blocks 1 and 2 summed first), each partial, the partials reduced in
    fp64 in the kernel's order; "bf16" keeps a1 . b1 alone.
    Returns (result (kd, kh, kw, CA, CB), plan, geometry)."""
    ta, tb, out, ws, plan, g = _args(a, b, ks, st, dtype)
    esize = ta.element_size()
    assert tuple(out.shape) == (*ks, a.shape[-1], b.shape[-1])
    assert (ws is None) == (g["splits"] * (2 if g["pingpong"] else 1) == 1
                            and not (g["a_parts"] or g["b_parts"]))
    acc_t = np.float64 if arith == "float64" else np.float32
    av, bv = _views(ta.double().numpy().astype(acc_t), tb.double().numpy().astype(acc_t), g)
    tapvox = _tapvox(g)
    # ping-pong: warpgroup w walks boxes bx0 + w, bx0 + w + 2, ... and writes
    # partial 2 split + w; else one partial a split
    pp = g["pingpong"]
    nparts = g["splits"] * (2 if pp else 1)
    parts = [np.zeros((g["ntaps"] * g["ca"], g["cb"]), acc_t) for _ in range(nparts)]
    written = np.zeros((nparts, g["ntaps"] * g["ca"], g["cb"]), int)
    stages, tiles = {}, {}
    walks = [(t0, ntb, ca0, n0, 2 * split + w if pp else split,
              np.arange(bx0 + w, bx1, 2) if pp else np.arange(bx0, bx1))
             for t0, ntb, ca0, n0, split, bx0, bx1 in _units(g) for w in ((0, 1) if pp else (0,))]
    for t0, ntb, ca0, n0, part, boxes in walks:
        if ca0 not in stages:
            if g["a_parts"]:  # fp32's bf16 planes, TMA'd as bf16's boxes (the value carried)
                stages[ca0] = _fill_a(av, g, ca0, 2)
            else:
                stages[ca0] = _fill_a(av, g, ca0, esize)
                if esize == 4:
                    stages[ca0] = _convert_a(stages[ca0], g)
        if n0 not in tiles:
            tiles[n0] = _b_tile(bv, g, n0, esize)
        rows = _a_rows(stages[ca0][boxes], g, t0, ntb, tapvox)
        bt = tiles[n0][boxes]
        if arith == "float64":
            acc = np.einsum("qrk,qkn->rn", rows, bt) if len(boxes) else \
                np.zeros((rows.shape[1], g["bn"]))
        else:
            assert dtype == torch.float32
            acc = np.zeros((rows.shape[1], g["bn"]), np.float32)
            ap, bp = _parts(rows), _parts(bt)
            for q in range(rows.shape[0]):
                chain = [np.zeros_like(acc) for _ in range(3)]  # column blocks of b1, b2, b3
                for s in range(cv.WGRAD_BOX // 16):  # k16 steps
                    k = slice(16 * s, 16 * s + 16)
                    x1, x2, x3 = (x[q, :, k] for x in ap)
                    y1, y2, y3 = (y[q, k] for y in bp)
                    if arith == "bf16x3":
                        terms = ((0, x1, y1), (1, x1, y2), (2, x1, y3), (0, x2, y1), (1, x2, y2),
                                 (0, x3, y1))
                    else:
                        terms = ((0, x1, y1),)
                    for c, u, v in terms:
                        chain[c] += u @ v
                acc += chain[0] + (chain[1] + chain[2])
        r = np.arange(ntb * g["width"])
        c = ca0 + (r & (g["width"] - 1))
        n = n0 + np.arange(g["bn"])
        ok_r, ok_n = c < g["ca"], n < g["cb"]
        m = (t0 + (r >> _log2(g["width"]))) * g["ca"] + c
        sel = np.ix_(m[ok_r], n[ok_n])
        parts[part][sel] = acc[:ntb * g["width"]][np.ix_(ok_r, ok_n)]
        written[part][sel] += 1
    assert (written == 1).all()  # every partial writes every output element once
    if nparts > 1:  # the reduce sums in fp64 and rounds to fp32
        total = _reduce([p.astype(np.float64) for p in parts]).astype(acc_t)
    else:
        total = parts[0]
    return total.reshape(*ks, a.shape[-1], b.shape[-1]), plan, g


def _jax_kernel_grad(a, b, ks, st):
    """jax.grad of sum(conv(A, W) * B) over W: K6's function."""
    w0 = jnp.zeros((*ks, a.shape[-1], b.shape[-1]), jnp.float32)

    def loss(w):
        y = jax.lax.conv_general_dilated(jnp.asarray(a), w, st, "SAME", dimension_numbers=DN)
        return jnp.sum(y * jnp.asarray(b))

    return np.asarray(jax.grad(loss)(w0))


def _err(got, ref):
    return float((np.abs(got - ref) / np.maximum(1.0, np.abs(ref))).max())


# ------------------------------------------------------- the kernel's source
def _source():
    with open(SRC) as f:
        return f.read()


def test_wgrad_constants_are_the_kernels():
    """The box, the ring's depth, the reduce's groups, the geometry's size,
    the tile widths a dtype launches and the tiles a warpgroup holds agree
    with csrc/conv3d_wgrad.cu."""
    text = _source()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kBox") == cv.WGRAD_BOX
    assert const("kMaxStages") == cv.WGRAD_STAGES[1]
    assert const("kReduceGroups") == cv.WGRAD_REDUCE_GROUPS
    assert const("kGeom") == cv.WGRAD_GEOM == len(FIELDS) + 2 * len(TRIPLES)
    body = text[text.index("int launch_bn("):text.index("int run(")]
    cases = [int(n) for n in re.findall(r"case (\d+):", body)]
    assert tuple(cases) == cv.WGRAD_TILES_N[torch.bfloat16]
    fp32 = tuple(int(n) for n in re.findall(r"case (\d+): return launch_mt<T, \d+>", body))
    assert cv.WGRAD_TILES_N[torch.float32] == fp32  # the rest bf16 alone
    rule = re.search(r"return Elem<T>::kF32 \? \(bn <= (\d+) \? (\d+) : (\d+)\) : "
                     r"\(bn <= (\d+) \? (\d+) : (\d+)\);", text)
    f_le, f_mt, f_else, b_le, b_mt, b_else = (int(x) for x in rule.groups())
    for bn in cv.WGRAD_TILES_N[torch.float32]:
        assert cv.WGRAD_MT[torch.float32][bn] == (f_mt if bn <= f_le else f_else)
    for bn in cv.WGRAD_TILES_N[torch.bfloat16]:
        assert cv.WGRAD_MT[torch.bfloat16][bn] == (b_mt if bn <= b_le else b_else)


def test_wgrad_geometry_fields_are_what_the_c_entry_reads():
    """Every field of the geometry array is read by pmr_conv3d_wgrad at the
    index the replay (FIELDS) and wgrad_args put it."""
    text = _source()
    entry = text[text.index('extern "C" int pmr_conv3d_wgrad('):]
    read = {m.group(1): int(m.group(2))
            for m in re.finditer(r"p\.(\w+) = g\[(\d+)\][;,]", entry)}
    read.update({m.group(1): int(m.group(2)) for m in
                 re.finditer(r"p\.(\w+)\[i\] = g\[(\d+) \+ i\];", entry)})
    assert read == FIELDS
    assert len(re.findall(r"g\[\d+( \+ i)?\]", entry)) == len(FIELDS)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ashape,ks,st,cb", CASES[:4])
def test_wgrad_geometry_is_the_plan(ashape, ks, st, cb, dtype):
    """The geometry array holds the plan's values and the call's shapes in
    the kernel's view, and the C entry's checks hold."""
    a, b = _case(np.random.default_rng(1), ashape, ks, st, cb)
    _, _, out, ws, plan, g = _args(a, b, ks, st, dtype)
    v = plan["view"]
    assert [g["a_d"], g["a_h"], g["a_w"], g["o_d"], g["o_h"], g["o_w"]] == [*v["a"], *v["o"]]
    assert (g["ca"], g["cb"], (g["kd"], g["kh"], g["kw"])) == (ashape[-1], cb, ks)
    for k in ("tile", "box", "tiles_ax"):
        assert tuple(g[k]) == tuple(plan[k])
    for k in ("width", "tpb", "tap_groups", "slabs", "bn", "n_tiles", "splits", "nbox",
              "a_stage", "b_stage", "stages", "smem", "ntaps"):
        assert g[k] == plan[k], k
    assert (g["a_tma"], g["b_tma"]) == plan["tma"] and g["pingpong"] == plan["pingpong"]
    assert g["ntaps"] == math.prod(ks) and g["tap_groups"] * g["tpb"] >= g["ntaps"]
    assert g["slabs"] * g["width"] >= g["ca"] and g["splits"] <= g["nbox"]
    assert g["tpb"] * g["width"] <= 64 * cv.WGRAD_MT[dtype][g["bn"]] * (1 if g["pingpong"] else 2)
    assert math.prod(g["tile"]) == cv.WGRAD_BOX and g["nbox"] == g["batch"] * math.prod(
        g["tiles_ax"])
    assert (0 if ws is None else ws.numel()) == plan["workspace"]


# --------------------------------------------------------------- coverage
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ashape,ks,st,cb", CASES)
def test_wgrad_boxes_cover_every_output_voxel_once(ashape, ks, st, cb, dtype):
    """The splits walk every box once, and the boxes' voxels (decoded by
    the kernel's shifts) cover B's grid once; voxels past it are padding."""
    a, b = _case(np.random.default_rng(2), ashape, ks, st, cb)
    _, _, _, _, plan, g = _args(a, b, ks, st, dtype)
    walked = np.zeros(g["nbox"], int)
    for split in range(g["splits"]):
        walked[g["nbox"] * split // g["splits"]:g["nbox"] * (split + 1) // g["splits"]] += 1
    assert (walked == 1).all()
    bq, oz, oy, ox = _boxes(g)
    z, y, x = _tile_voxel(g, np.arange(cv.WGRAD_BOX))
    gz, gy, gx = oz[:, None] + z, oy[:, None] + y, ox[:, None] + x
    ok = (gz < g["o_d"]) & (gy < g["o_h"]) & (gx < g["o_w"])
    seen = np.zeros((g["batch"], g["o_d"], g["o_h"], g["o_w"]), int)
    np.add.at(seen, (np.broadcast_to(bq[:, None], ok.shape)[ok], gz[ok], gy[ok], gx[ok]), 1)
    assert (seen == 1).all()


@pytest.mark.parametrize("ashape,ks,st,cb", CASES)
def test_wgrad_taps_lie_inside_the_halo_box(ashape, ks, st, cb):
    """Every tap's row of every box voxel is inside the halo box, at the
    A voxel o * s + t - lo the gradient reads (K2's strides included)."""
    a, b = _case(np.random.default_rng(3), ashape, ks, st, cb)
    _, _, _, _, _, g = _args(a, b, ks, st, torch.float32)
    k = np.arange(cv.WGRAD_BOX)
    rv = _rowvox(g, k)[:, None] + _tapvox(g)[None]
    assert rv.min() >= 0 and rv.max() < math.prod(g["box"])
    bx, by = g["box"][2], g["box"][1]
    hz, hy, hx = rv // (bx * by), (rv // bx) % by, rv % bx
    z, y, x = _tile_voxel(g, k)
    t = np.arange(g["ntaps"])
    tz, ty, tx = t // (g["kw"] * g["kh"]), (t // g["kw"]) % g["kh"], t % g["kw"]
    np.testing.assert_array_equal(hz, z[:, None] * g["st"][0] + tz[None])
    np.testing.assert_array_equal(hy, y[:, None] * g["st"][1] + ty[None])
    np.testing.assert_array_equal(hx, x[:, None] * g["st"][2] + tx[None])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ashape,ks,st,cb", CASES)
def test_wgrad_block_rows_cover_m_once(ashape, ks, st, cb, dtype):
    """The blocks' rows (taps x slab channels, within the warpgroups'
    tiles) and channel tiles cover taps x CA by CB once a split."""
    a, b = _case(np.random.default_rng(4), ashape, ks, st, cb)
    _, _, _, _, plan, g = _args(a, b, ks, st, dtype)
    cover = np.zeros((g["splits"], g["ntaps"] * g["ca"], g["cb"]), int)
    for t0, ntb, ca0, n0, split, _, _ in _units(g):
        assert ntb * g["width"] <= 64 * cv.WGRAD_MT[dtype][g["bn"]] * (1 if g["pingpong"] else 2)
        r = np.arange(ntb * g["width"])
        c = ca0 + (r % g["width"])
        m = ((t0 + r // g["width"]) * g["ca"] + c)[c < g["ca"]]
        cover[split][np.ix_(m, np.arange(n0, min(n0 + g["bn"], g["cb"])))] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("dtype,ashape,ks,cb", [
    (torch.bfloat16, (2, 5, 9, 10, 3), (1, 3, 3), 16),
    (torch.float32, (2, 5, 9, 10, 3), (1, 3, 3), 16),
    (torch.bfloat16, (2, 4, 6, 6, 4), (3, 3, 3), 1),
    (torch.bfloat16, (2, 6, 8, 10, 12), (3, 3, 3), 8),
    (torch.float32, (1, 6, 12, 12, 33), (3, 3, 3), 2)])
def test_wgrad_staged_rows_equal_the_gathered_window(dtype, ashape, ks, cb):
    """The staged route (CA that makes no 16-byte voxel stride; CB 1, 2):
    the box the producer writes, read at each tap's shifted rows by the
    consumers' addresses, is A's zero-padded window o + t - lo at the slab's
    channels (zero past CA)."""
    a, b = _case(np.random.default_rng(5), ashape, ks, (1, 1, 1), cb)
    ta, tb, _, _, plan, g = _args(a, b, ks, (1, 1, 1), dtype)
    assert cv.wgrad_routes(ta, tb)[0] == "staged"
    esize = ta.element_size()
    av, _ = _views(ta.double().numpy(), tb.double().numpy(), g)
    if g["a_parts"]:  # fp32's stem: A split into bf16 planes, TMA'd as bf16 boxes
        assert g["a_tma"]
        stage = _fill_a(av, g, 0, 2)
    else:
        assert not g["a_tma"]
        stage = _fill_a(av, g, 0, esize)
        if esize == 4:
            stage = _convert_a(stage, g)
    rows = _a_rows(stage, g, 0, g["tpb"], _tapvox(g))
    bq, oz, oy, ox = _boxes(g)
    z, y, x = _tile_voxel(g, np.arange(cv.WGRAD_BOX))
    for r in range(g["tpb"] * g["width"]):
        t, c = r // g["width"], r % g["width"]
        tz, ty, tx = t // (ks[1] * ks[2]), (t // ks[2]) % ks[1], t % ks[2]
        gz = oz[:, None] + z + tz - g["lo"][0]
        gy = oy[:, None] + y + ty - g["lo"][1]
        gx = ox[:, None] + x + tx - g["lo"][2]
        inside = ((gz >= 0) & (gz < g["a_d"]) & (gy >= 0) & (gy < g["a_h"]) & (gx >= 0)
                  & (gx < g["a_w"]) & (c < g["ca"]))
        want = av[np.broadcast_to(bq[:, None], gz.shape), np.clip(gz, 0, g["a_d"] - 1),
                  np.clip(gy, 0, g["a_h"] - 1), np.clip(gx, 0, g["a_w"] - 1), min(c, g["ca"] - 1)]
        np.testing.assert_array_equal(rows[:, r], np.where(inside, want, 0))


# ------------------------------------------------------- the arithmetic
@pytest.mark.parametrize("dtype", DTYPES)
def test_wgrad_cases_reach_both_schedules(dtype):
    """The replayed cases take both schedules of the warpgroups: split and
    ping-pong (the plan's choice by its estimate)."""
    plans = [cv.wgrad_plan(a, cb, ks, st, dtype) for a, ks, st, cb in CASES]
    assert {p["pingpong"] for p in plans} == {False, True}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ashape,ks,st,cb", CASES)
def test_wgrad_replay_is_the_weight_gradient(ashape, ks, st, cb, dtype):
    """The schedule in exact arithmetic on the dtype's operands: the fp64
    twin (1e-10 of the output's largest |value|) and JAX's kernel gradient
    of the same convolution (the fp32 oracle tolerance, relative to the
    output's largest |value|)."""
    rng = np.random.default_rng(8)
    a, b = _case(rng, ashape, ks, st, cb)
    got, _, _ = replay_wgrad(a, b, ks, st, dtype)
    ar, br = (_t(x).to(dtype).double() for x in (a, b))
    twin = cv.conv3d_wgrad_plain(ar, br, ks, st).numpy()
    scale = max(1.0, float(np.abs(twin).max()))
    assert float(np.abs(got - twin).max()) <= 1e-10 * scale
    want = _jax_kernel_grad(ar.float().numpy(), br.float().numpy(), ks, st)
    assert float(np.abs(got - want).max()) <= 2e-5 * scale


@pytest.mark.parametrize("arith,holds", [("bf16x3", True), ("bf16", False)])
def test_wgrad_fp32_replay_holds_the_fp32_limit_at_level0(arith, holds):
    """A level-0-like (1,3,3) gradient of 16 channels over 65,536 rows (the
    cfg1 stem block's shape at a quarter of its extent): the kernel's fp32
    arithmetic (three bf16 parts, six products) within 2e-4 of the fp64
    product per element; bf16 products alone are not."""
    rng = np.random.default_rng(9)
    a, b = _case(rng, (1, 4, 128, 128, 16), (1, 3, 3), (1, 1, 1), 16)
    got, plan, g = replay_wgrad(a, b, (1, 3, 3), (1, 1, 1), torch.float32, arith)
    assert g["splits"] > 8 and g["nbox"] == 512  # both orders of the reduce are replayed
    exact = cv.conv3d_wgrad_plain(_t(a).double(), _t(b).double(), (1, 3, 3)).numpy()
    assert (_err(got, exact) <= FP32_LIMIT) == holds, _err(got, exact)


# --------------------------------------------------------------- routes
@pytest.mark.parametrize("dtype,ca,cb,want", [
    (torch.bfloat16, 3, 16, ("staged", "tma")),   # the stem: 6 bytes a voxel
    (torch.float32, 3, 16, ("staged", "tma")),
    (torch.bfloat16, 4, 4, ("staged", "staged")),
    (torch.float32, 4, 4, ("tma", "tma")),
    (torch.bfloat16, 16, 2, ("tma", "staged")),
    (torch.bfloat16, 12, 1, ("staged", "staged")),
    (torch.float32, 16, 1, ("tma", "staged")),
    (torch.float32, 6, 2, ("staged", "staged")),
    (torch.bfloat16, 8, 8, ("tma", "tma"))])
def test_wgrad_routes_follow_channels_and_alignment(dtype, ca, cb, want):
    """TMA where a voxel is a multiple of 16 bytes and the base aligned,
    else staged; the geometry carries the routes."""
    a = torch.zeros(1, 2, 3, 4, ca, dtype=dtype)
    b = torch.zeros(1, 2, 3, 4, cb, dtype=dtype)
    assert cv.wgrad_routes(a, b) == want
    _, _, plan, geom = cv.wgrad_args(a, b, (1, 1, 1), (1, 1, 1))
    # an fp32 operand split into bf16 planes before the kernel comes by TMA
    parts = (plan["a_parts"], plan["b_parts"])
    assert tuple(geom[35:37]) == tuple(int(w == "tma" or q) for w, q in zip(want, parts))
    # a base one element off the 16-byte grid takes the staged route
    flat = torch.zeros(a.numel() + 1, dtype=dtype)
    shifted = flat[1:].view(a.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    assert cv.wgrad_routes(shifted, b)[0] == "staged"


# ------------------------------------------------- the plan at cfg1 size
L0, L1, L2, L3, L4 = (20, 160, 160), (20, 80, 80), (20, 40, 40), (10, 20, 20), (5, 10, 10)
# K6's signatures in one cfg1 train step at batch 2: (A's grid, CA, kernel,
# strides, CB); B's grid is A's SAME output
TRAIN_SHAPES = [
    (L0, 3, (1, 3, 3), (1, 1, 1), 16), (L0, 16, (1, 3, 3), (1, 1, 1), 16),
    (L0, 16, (1, 3, 3), (1, 1, 1), 4), (L0, 4, (3, 3, 3), (1, 1, 1), 4),
    (L0, 16, (1, 1, 1), (1, 1, 1), 16), (L0, 4, (1, 1, 1), (1, 1, 1), 16),
    (L0, 16, (1, 1, 1), (1, 1, 1), 1), (L0, 16, (1, 1, 1), (1, 1, 1), 2),
    (L0, 16, (1, 3, 3), (1, 2, 2), 32), (L0, 16, (1, 3, 3), (1, 2, 2), 8),
    (L1, 32, (1, 3, 3), (1, 1, 1), 32), (L1, 32, (1, 3, 3), (1, 1, 1), 8),
    (L1, 8, (3, 3, 3), (1, 1, 1), 8), (L1, 8, (1, 1, 1), (1, 1, 1), 32),
    (L1, 32, (1, 1, 1), (1, 1, 1), 32), (L1, 32, (1, 1, 1), (1, 1, 1), 1),
    (L1, 32, (3, 3, 3), (1, 2, 2), 64), (L1, 32, (3, 3, 3), (1, 2, 2), 16),
    (L2, 64, (3, 3, 3), (1, 1, 1), 64), (L2, 64, (3, 3, 3), (1, 1, 1), 16),
    (L2, 16, (3, 3, 3), (1, 1, 1), 16), (L2, 16, (1, 1, 1), (1, 1, 1), 64),
    (L2, 64, (1, 1, 1), (1, 1, 1), 64), (L2, 64, (1, 1, 1), (1, 1, 1), 1),
    (L2, 64, (3, 3, 3), (2, 2, 2), 128), (L2, 64, (3, 3, 3), (2, 2, 2), 32),
    (L3, 128, (3, 3, 3), (1, 1, 1), 128), (L3, 128, (3, 3, 3), (1, 1, 1), 32),
    (L3, 32, (3, 3, 3), (1, 1, 1), 32), (L3, 32, (1, 1, 1), (1, 1, 1), 128),
    (L3, 128, (1, 1, 1), (1, 1, 1), 128), (L3, 128, (1, 1, 1), (1, 1, 1), 1),
    (L3, 128, (3, 3, 3), (2, 2, 2), 256), (L3, 128, (3, 3, 3), (2, 2, 2), 64),
    (L4, 64, (3, 3, 3), (1, 1, 1), 64), (L4, 64, (1, 1, 1), (1, 1, 1), 256),
    (L4, 256, (1, 1, 1), (1, 1, 1), 128), (L4, 256, (1, 1, 1), (1, 1, 1), 64),
    (L4, 256, (1, 1, 1), (1, 1, 1), 32), (L4, 256, (1, 1, 1), (1, 1, 1), 16)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,ca,ks,st,cb", TRAIN_SHAPES)
def test_wgrad_plan_fits_the_card_at_cfg1(grid, ca, ks, st, cb, dtype):
    """At every K6 shape of a cfg1 train step (batch 2): the stages fit one
    block's shared memory, the halo box TMA's 256 a side, a block's rows
    its warpgroups' tiles, the grid and the boxes the C entry's checks; a
    bf16 slab is a 16-byte ldmatrix row at least; ping-pong's stages an
    even count (each stage's boxes one warpgroup's)."""
    plan = cv.wgrad_plan((2, *grid, ca), cb, ks, st, dtype)
    assert plan["smem"] <= cv.WG_SMEM_BLOCK and cv.WGRAD_STAGES[0] <= plan["stages"] <= \
        cv.WGRAD_STAGES[1]
    assert plan["stages"] % 2 == 0 or not plan["pingpong"]
    assert max(plan["box"]) <= cv.WG_BOX_MAX and math.prod(plan["tile"]) == cv.WGRAD_BOX
    assert plan["tpb"] * plan["width"] <= 64 * plan["mt"] * (1 if plan["pingpong"] else 2)
    assert plan["width"] * (16 // cv._vec(dtype)) >= 16 and plan["width"] <= 128 // (
        16 // cv._vec(dtype))
    assert 1 <= plan["splits"] <= plan["nbox"] and plan["blocks"] <= 65535
    assert plan["n_tiles"] * plan["bn"] >= cb and plan["slabs"] * plan["width"] >= ca


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,ca,ks,st,cb", TRAIN_SHAPES)
def test_wgrad_workspace_and_stages_hold_the_parts(grid, ca, ks, st, cb, dtype):
    """At every K6 shape of a cfg1 train step: ping-pong exactly for a flat
    gradient; an fp32 operand in parts has a stage of three bf16 boxes (A:
    of the slab, B: of the tile's channels) and its three planes in the
    workspace at the offsets pmr_conv3d_wgrad takes (after the partials,
    each at the next 256 bytes, channels rounded up to 8); bf16 has no
    parts."""
    plan = cv.wgrad_plan((2, *grid, ca), cb, ks, st, dtype)
    assert plan["pingpong"] == plan["flat"]
    if dtype == torch.bfloat16:
        assert not (plan["a_parts"] or plan["b_parts"])
    kb = lambda n: -(-n // 1024) * 1024  # noqa: E731
    es = 16 // cv._vec(dtype)
    assert plan["a_stage"] == (3 * kb(plan["box_vox"] * plan["width"] * 2) if plan["a_parts"]
                               else kb(plan["box_vox"] * plan["width"] * es))
    assert plan["b_stage"] == (kb(3 * cv.WGRAD_BOX * plan["bn"] * 2) if plan["b_parts"]
                               else kb(cv.WGRAD_BOX * plan["bn"] * es))
    assert plan["tma"][0] or not plan["a_parts"]
    partials = plan["splits"] * (2 if plan["pingpong"] else 1)
    off = partials * plan["m"] * cb * 4 if partials > 1 else 0
    voxels = (2 * math.prod(grid), 2 * math.prod(plan["out"]))
    for used, vox, c in ((plan["a_parts"], voxels[0], ca), (plan["b_parts"], voxels[1], cb)):
        if used:
            off = -(-off // 256) * 256 + 3 * vox * (-(-c // 8) * 8) * 2
    assert off <= plan["workspace"] * 4 < off + 256 + 4


@pytest.mark.parametrize("flag", ["a_parts", "b_parts"])
def test_wgrad_fp32_cases_reach_both_routes_of_parts(flag):
    """The replayed fp32 cases take each operand both in parts and converted
    in the blocks, so the replay checks both."""
    plans = [cv.wgrad_plan(a, cb, ks, st, torch.float32) for a, ks, st, cb in CASES]
    assert {p[flag] for p in plans} == {False, True}
