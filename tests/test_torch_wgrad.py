"""K6 ``conv3d_wgrad``'s schedule on the CPU: a numpy replay of what
csrc/conv3d_wgrad.cu does with the plan and the geometry array the wrapper
hands it (``convolution.wgrad_args``).

  * the tile family and its constants agree with the kernel's source;
  * each variant's warps and fragments cover its BM x BN tile once, and the
    chunks, stages, warps and mma steps of the plan cover every row once;
    the row cursor (one carry a digit) gives each row's coordinates;
  * the replay in exact arithmetic (the gather through the kernel's row and
    column tables, the chunks' partials, the ordered reduce) is the weight
    gradient: the fp64 twin at 1e-10 relative, and ``jax.grad`` of the
    convolution at the repo's fp32 oracle tolerance (2e-5);
  * the replay in the kernel's fp32 arithmetic (3xTF32 k8 steps into chains
    promoted every WGRAD_CHAIN_STEPS steps, the WK warps' tiles summed in
    order, the chunks reduced in eight ordered groups) holds the card's fp32
    limit, |diff| / max(1, |ref|) <= 2e-4 per element of the fp64 product,
    at a level-0-like shape of 65,536 rows; TF32 alone does not.
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
from test_torch_ops import _tf32

FP32_LIMIT = 2e-4  # chip_smoke.FP32_LIMIT
DN = ("NDHWC", "DHWIO", "NDHWC")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(rng, ashape, ks, st, cb):
    a = rng.normal(size=ashape).astype(np.float32)
    out = [cv.same_pads(n, k, s)[0] for n, k, s in zip(ashape[1:4], ks, st)]
    b = rng.normal(size=(ashape[0], *out, cb)).astype(np.float32)
    return a, b


def _rows_of_plan(plan, dtype):
    """Per chunk c, stage i, warp wk and mma step st: the first row of the
    step's KS rows (as the kernel walks them), shape (chunks, stages, WK,
    KSTEPS)."""
    ks_rows = cv.WGRAD_KS[dtype]
    stages = -(-plan["chunk_rows"] // plan["stage_rows"])
    c = np.arange(plan["chunks"])[:, None, None, None]
    i = np.arange(stages)[None, :, None, None]
    wk = np.arange(plan["wk"])[None, None, :, None]
    st = np.arange(plan["ksteps"])[None, None, None, :]
    return (c * plan["chunk_rows"] + i * plan["stage_rows"]
            + (wk * plan["ksteps"] + st) * ks_rows), ks_rows


def _cursor_rows(geom, plan):
    """The kernel's row cursor (write_rows): each of the stage's first
    threads starts at its row's (batch, d, h, w) and adds the stage's rows
    in mixed radix, one carry a digit. Returns (batch, d, h, w) of every
    row r < rows, indexed by r."""
    o_d, o_h, o_w = (int(v) for v in geom[4:7])
    rows = int(geom[17]) * o_d * o_h * o_w
    bk, chunk_rows, chunks = plan["stage_rows"], plan["chunk_rows"], plan["chunks"]
    tid = np.arange(bk)[None, :]
    q = np.arange(chunks)[:, None] * chunk_rows + tid
    cw, q = q % o_w, q // o_w
    ch, q = q % o_h, q // o_h
    cd, cbt = q % o_d, q // o_d
    dq = bk
    dw, dq = dq % o_w, dq // o_w
    dh, dq = dq % o_h, dq // o_h
    dd, dbt = dq % o_d, dq // o_d
    out = np.full((rows, 4), -1, np.int64)
    for s in range(-(-chunk_rows // bk)):
        r = np.arange(chunks)[:, None] * chunk_rows + s * bk + tid
        end = np.minimum(rows, np.arange(chunks)[:, None] * chunk_rows + chunk_rows)
        ok = r < end
        assert (out[r[ok]] == -1).all(), "a row written twice"
        out[r[ok]] = np.stack([cbt, cd, ch, cw], -1)[ok]
        cw = cw + dw
        c = cw >= o_w
        cw = np.where(c, cw - o_w, cw)
        ch = ch + dh + c
        c = ch >= o_h
        ch = np.where(c, ch - o_h, ch)
        cd = cd + dd + c
        c = cd >= o_d
        cd = np.where(c, cd - o_d, cd)
        cbt = cbt + dbt + c
    return out


def _gather(a, geom, plan):
    """Â (rows x M) as the kernel loads it: the row table (z0, y0, x0, voxel)
    from the cursor, the column table (dz, dy, dx, element offset), A's
    element voxel * CA + offset where the tap lies inside A, else 0."""
    a_d, a_h, a_w, ca = (int(v) for v in geom[0:4])
    kd, kh, kw = (int(v) for v in geom[8:11])
    sd, sh, sw = (int(v) for v in geom[11:14])
    ld, lh, lw = (int(v) for v in geom[14:17])
    coords = _cursor_rows(geom, plan)
    o = np.stack(np.unravel_index(np.arange(len(coords)), (int(geom[17]), *geom[4:7])), -1)
    np.testing.assert_array_equal(coords, o)  # the cursor is the row's coordinates
    cbt, cd, ch, cw = coords.T
    z0, y0, x0 = cd * sd - ld, ch * sh - lh, cw * sw - lw
    vox = ((cbt * a_d + z0) * a_h + y0) * a_w + x0
    m = np.arange(kd * kh * kw * ca)
    t, ci = m // ca, m % ca
    tw, th, td = t % kw, (t // kw) % kh, t // (kw * kh)
    off = ((td * a_h + th) * a_w + tw) * ca + ci
    z, y, x = z0[:, None] + td, y0[:, None] + th, x0[:, None] + tw
    ok = (z >= 0) & (z < a_d) & (y >= 0) & (y < a_h) & (x >= 0) & (x < a_w)
    idx = np.where(ok, vox[:, None] * ca + off, 0)
    return np.where(ok, a.reshape(-1)[idx], 0)


def _reduce(parts):
    """wgrad_reduce_kernel's order: group g sums chunks g, g + 8, ... in
    order, then the groups in order."""
    chunks, groups = len(parts), cv.WGRAD_REDUCE_GROUPS
    sums = []
    for g in range(min(groups, chunks)):
        s = parts[g].copy()
        for j in range(g + groups, chunks, groups):
            s += parts[j]
        sums.append(s)
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    return total


def _emulate_wgrad(a, b, ks, st, dtype, arith="float64"):
    """numpy replay of csrc/conv3d_wgrad.cu in ``dtype`` from the plan and
    the geometry the wrapper packs. The operands are rounded to ``dtype``;
    "float64" sums exactly, which checks the schedule; "3xtf32" (fp32) runs
    the kernel's arithmetic: each warp's k8 steps of lo*hi + hi*lo + hi*hi
    into an fp32 chain, added into fp32 sums every WGRAD_CHAIN_STEPS steps
    and at the end, the WK warps' tiles summed in order, the chunks'
    partials reduced in the kernel's order; "tf32" keeps hi*hi alone.
    Returns (result (taps * CA, CB), plan)."""
    ta, tb = _t(a).to(dtype), _t(b).to(dtype)
    out, ws, plan, geom = cv.wgrad_args(ta, tb, ks, st)
    assert tuple(out.shape) == (*ks, a.shape[-1], b.shape[-1])
    assert (ws is None) == (plan["chunks"] == 1)
    assert (0 if ws is None else ws.numel()) == plan["workspace"]
    acc_t = np.float64 if arith == "float64" else np.float32
    av, bv = ta.double().numpy(), tb.double().numpy()
    rows, cb = int(np.prod(b.shape[:4])), b.shape[-1]
    a_hat = _gather(av, geom, plan).astype(acc_t)
    bm = bv.reshape(rows, cb).astype(acc_t)
    first, ks_rows = _rows_of_plan(plan, dtype)
    steps = first.shape[1] * first.shape[3]  # a warp's mma steps in one chunk
    nchunk, wk = first.shape[0], first.shape[2]
    m = a_hat.shape[1]
    if arith == "float64":
        parts = [a_hat[c * plan["chunk_rows"]:(c + 1) * plan["chunk_rows"]].T
                 @ bm[c * plan["chunk_rows"]:(c + 1) * plan["chunk_rows"]]
                 for c in range(nchunk)]
    else:
        assert dtype == torch.float32
        pad = np.zeros((1, m), acc_t), np.zeros((1, cb), acc_t)
        a_pad, b_pad = np.concatenate([a_hat, pad[0]]), np.concatenate([bm, pad[1]])
        acc = np.zeros((nchunk, wk, m, cb), np.float32)
        chain = np.zeros_like(acc)
        terms = ("lh", "hl", "hh") if arith == "3xtf32" else ("hh",)
        ends = np.minimum(rows, (np.arange(nchunk) + 1) * plan["chunk_rows"])
        for i in range(first.shape[1]):
            for s in range(first.shape[3]):
                r = first[:, i, :, s][..., None] + np.arange(ks_rows)  # (chunks, wk, 8)
                r = np.where(r < ends[:, None, None], r, rows)  # past the chunk: zeros
                x = np.swapaxes(a_pad[r], -1, -2)  # (chunks, wk, m, 8)
                w = b_pad[r]                        # (chunks, wk, 8, cb)
                xh, wh = _tf32(x), _tf32(w)
                xl, wl = _tf32(x - xh), _tf32(w - wh)
                for term in terms:
                    p, q = {"lh": (xl, wh), "hl": (xh, wl), "hh": (xh, wh)}[term]
                    chain += p @ q
                step = i * first.shape[3] + s + 1
                if step % cv.WGRAD_CHAIN_STEPS == 0:
                    acc += chain
                    chain[:] = 0
        assert steps % cv.WGRAD_CHAIN_STEPS != 0 or not chain.any()
        acc += chain
        parts = []
        for c in range(nchunk):
            tile = acc[c, 0].copy()
            for k in range(1, wk):  # the epilogue's order over the K warps
                tile += acc[c, k]
            parts.append(tile)
    total = parts[0] if nchunk == 1 else _reduce(parts)
    return total.reshape(*ks, a.shape[-1], cb), plan


def _jax_kernel_grad(a, b, ks, st):
    """jax.grad of sum(conv(A, W) * B) over W: K6's function."""
    w0 = jnp.zeros((*ks, a.shape[-1], b.shape[-1]), jnp.float32)

    def loss(w):
        y = jax.lax.conv_general_dilated(jnp.asarray(a), w, st, "SAME", dimension_numbers=DN)
        return jnp.sum(y * jnp.asarray(b))

    return np.asarray(jax.grad(loss)(w0))


def _err(got, ref):
    return float((np.abs(got - ref) / np.maximum(1.0, np.abs(ref))).max())


# ------------------------------------------------------------ the family
def test_wgrad_variants_are_the_kernels():
    """WGRAD_VARIANTS, the chain length and the reduce's groups agree with
    csrc/conv3d_wgrad.cu (launch_bm_bn, kChainSteps, kReduceGroups)."""
    src = os.path.join(os.path.dirname(cv.__file__), "..", "csrc", "conv3d_wgrad.cu")
    with open(src) as f:
        text = f.read()
    body = text[text.index("int launch_bm_bn("):text.index("int run(")]
    guard = body.index("if constexpr (kBF16)")  # the bf16-only variants follow it
    found = {torch.float32: set(), torch.bfloat16: set()}
    for x in re.finditer(r"bm == (\d+) && bn == (\d+)\) return launch_tile<T, ([\d, ]+)>", body):
        v = tuple(int(n) for n in x.group(3).split(","))
        tile = cv.wgrad_tile(v, torch.bfloat16)
        assert (tile["bm"], tile["bn"]) == (int(x.group(1)), int(x.group(2)))
        found[torch.bfloat16].add(v)
        if x.start() < guard:
            found[torch.float32].add(v)
    for dtype, variants in cv.WGRAD_VARIANTS.items():
        assert set(variants) == found[dtype], dtype
    chain = int(re.search(r"constexpr int kChainSteps = (\d+);", text).group(1))
    groups = int(re.search(r"constexpr int kReduceGroups = (\d+);", text).group(1))
    assert (chain, groups) == (cv.WGRAD_CHAIN_STEPS, cv.WGRAD_REDUCE_GROUPS)


@pytest.mark.parametrize("dtype,variant", [(d, v) for d, vs in cv.WGRAD_VARIANTS.items()
                                           for v in vs])
def test_wgrad_fragments_cover_each_tile_once(dtype, variant):
    """Each K warp's (wm, wn) warps cover the BM x BN tile once through the
    C fragments (c0, c1 at (g, 2t..2t+1), c2, c3 at (g + 8, ...)); the
    stage's rows split over the K warps and their mma steps once."""
    tile = cv.wgrad_tile(variant, dtype)
    mt, nt, wm_n, wn_n, wk_n, ksteps = variant
    bm, bn = tile["bm"], tile["bn"]
    for wk in range(wk_n):
        seen = np.zeros((bm, bn), int)
        for wm in range(wm_n):
            for wn in range(wn_n):
                for lane in range(32):
                    g, t4 = lane >> 2, lane & 3
                    for i in range(mt):
                        for j in range(nt):
                            for h in range(2):
                                ml = wm * 16 * mt + i * 16 + g + h * 8
                                nl = wn * 8 * nt + j * 8 + 2 * t4
                                seen[ml, nl:nl + 2] += 1
        assert (seen == 1).all()
    ks_rows = cv.WGRAD_KS[dtype]
    rows = np.zeros(tile["stage_rows"], int)
    for wk in range(wk_n):
        for st in range(ksteps):
            k0 = (wk * ksteps + st) * ks_rows
            rows[k0:k0 + ks_rows] += 1
    assert (rows == 1).all()
    assert tile["stage_rows"] <= 32 * tile["warps"]  # one thread a row of the row table
    assert cv.WGRAD_CHAIN_STEPS % ksteps == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ashape,ks,st,cb", [
    ((2, 5, 9, 10, 16), (1, 3, 3), (1, 2, 2), 4),
    ((1, 4, 40, 40, 16), (1, 3, 3), (1, 1, 1), 16),
    ((2, 6, 8, 10, 12), (3, 3, 3), (2, 2, 2), 70),
    ((2, 3, 7, 9, 3), (1, 3, 3), (1, 1, 1), 1)])
def test_wgrad_plan_covers_every_row_once(ashape, ks, st, cb, dtype):
    """The plan's chunks, stages, K warps and mma steps walk every row
    exactly once (rows past the last chunk's end are zero-filled); every
    (m, n) of the output lies in exactly one block tile; the C entry's
    checks hold (chunks * chunk_rows covers the rows, no chunk is empty)."""
    rng = np.random.default_rng(7)
    a, b = _case(rng, ashape, ks, st, cb)
    _, _, plan, geom = cv.wgrad_args(_t(a).to(dtype), _t(b).to(dtype), ks, st)
    rows = int(np.prod(b.shape[:4]))
    m = int(np.prod(ks)) * ashape[-1]
    assert plan["chunk_rows"] % plan["stage_rows"] == 0
    assert plan["chunks"] * plan["chunk_rows"] >= rows > (plan["chunks"] - 1) * plan["chunk_rows"]
    first, ks_rows = _rows_of_plan(plan, dtype)
    ends = np.minimum(rows, (np.arange(plan["chunks"]) + 1) * plan["chunk_rows"])
    seen = np.zeros(rows, int)
    for c in range(plan["chunks"]):
        r = (first[c].reshape(-1)[:, None] + np.arange(ks_rows)).reshape(-1)
        assert ((r >= c * plan["chunk_rows"]) & (r < c * plan["chunk_rows"] + plan["chunk_rows"]
                                                  + plan["stage_rows"])).all()
        np.add.at(seen, r[r < ends[c]], 1)
    assert (seen == 1).all()
    covered = np.zeros((m, cb), int)
    for x in range(-(-m // plan["bm"])):
        for y in range(-(-cb // plan["bn"])):
            covered[x * plan["bm"]:(x + 1) * plan["bm"], y * plan["bn"]:(y + 1) * plan["bn"]] += 1
    assert (covered == 1).all() and plan["tiles"] == (-(-m // plan["bm"])) * (-(-cb // plan["bn"]))
    assert list(geom[18:22]) == [plan["chunks"], plan["bm"], plan["bn"], plan["chunk_rows"]]
    _cursor_rows(geom, plan)  # every row written once by the cursor


# ------------------------------------------------------- the arithmetic
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ashape,ks,st,cb", [
    ((2, 5, 9, 10, 3), (1, 3, 3), (1, 1, 1), 16),   # the stem's 3 channels: scalar A
    ((2, 5, 9, 10, 16), (1, 3, 3), (1, 2, 2), 4),   # a narrow head's 4 channels
    ((2, 6, 8, 10, 12), (3, 3, 3), (2, 2, 2), 70),  # 8 taps of padding at odd edges
    ((1, 3, 4, 4, 64), (3, 3, 3), (1, 1, 1), 128),  # the widest tiles
    ((2, 4, 6, 6, 4), (3, 3, 3), (1, 1, 1), 1)])
def test_wgrad_replay_is_the_weight_gradient(ashape, ks, st, cb, dtype):
    """The schedule in exact arithmetic on the dtype's operands: the fp64
    twin (1e-10 of the output's largest |value|) and JAX's kernel gradient
    of the same convolution (the fp32 oracle tolerance, relative to the
    output's largest |value|)."""
    rng = np.random.default_rng(8)
    a, b = _case(rng, ashape, ks, st, cb)
    got, plan = _emulate_wgrad(a, b, ks, st, dtype)
    ar, br = (_t(x).to(dtype).double() for x in (a, b))
    twin = cv.conv3d_wgrad_plain(ar, br, ks, st).numpy()
    scale = max(1.0, float(np.abs(twin).max()))
    assert float(np.abs(got - twin).max()) <= 1e-10 * scale
    want = _jax_kernel_grad(ar.float().numpy(), br.float().numpy(), ks, st)
    assert float(np.abs(got - want).max()) <= 2e-5 * scale


@pytest.mark.parametrize("arith,holds", [("3xtf32", True), ("tf32", False)])
def test_wgrad_fp32_replay_holds_the_fp32_limit_at_level0(arith, holds):
    """A level-0-like (1,3,3) gradient of 16 channels over 65,536 rows (the
    cfg1 stem block's shape at a quarter of its extent): the kernel's fp32
    arithmetic within 2e-4 of the fp64 product per element; plain TF32 is
    not."""
    rng = np.random.default_rng(9)
    a, b = _case(rng, (1, 4, 128, 128, 16), (1, 3, 3), (1, 1, 1), 16)
    got, plan = _emulate_wgrad(a, b, (1, 3, 3), (1, 1, 1), torch.float32, arith)
    assert plan["chunks"] > 1 and plan["wk"] > 1  # both orders of the sums are replayed
    exact = cv.conv3d_wgrad_plain(_t(a).double(), _t(b).double(), (1, 3, 3)).numpy()
    assert (_err(got, exact) <= FP32_LIMIT) == holds, _err(got, exact)


# --------------------------------------------------------------- routes
@pytest.mark.parametrize("dtype,ca,cb,want", [
    (torch.bfloat16, 3, 16, (0, 16)),   # the stem: bf16's odd count goes element-wise
    (torch.float32, 3, 16, (4, 16)),    # fp32: one channel a 4-byte copy
    (torch.bfloat16, 4, 4, (8, 8)),
    (torch.float32, 4, 4, (16, 16)),
    (torch.bfloat16, 16, 2, (16, 4)),
    (torch.bfloat16, 12, 1, (8, 0)),
    (torch.float32, 16, 1, (16, 4)),
    (torch.float32, 6, 2, (8, 8)),
    (torch.bfloat16, 8, 8, (16, 16))])
def test_wgrad_routes_follow_channels_and_alignment(dtype, ca, cb, want):
    """Each operand's copy width: the widest of 16, 8, 4 bytes dividing its
    channel row and its base; 0 (element-wise) where none does."""
    a = torch.zeros(1, 2, 3, 4, ca, dtype=dtype)
    b = torch.zeros(1, 2, 3, 4, cb, dtype=dtype)
    assert cv.wgrad_routes(a, b) == want
    _, _, _, geom = cv.wgrad_args(a, b, (1, 1, 1), (1, 1, 1))
    assert tuple(geom[22:24]) == want
    # a base one element off the 16-byte grid narrows the copies: bf16 to
    # element-wise (2 bytes off), fp32 to 4 bytes
    flat = torch.zeros(a.numel() + 1, dtype=dtype)
    shifted = flat[1:].view(a.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    assert cv.wgrad_routes(shifted, b)[0] == (0 if dtype == torch.bfloat16 else 4)


def test_wgrad_geometry_is_what_the_c_entry_reads():
    a = torch.zeros(2, 5, 9, 10, 16)
    b = torch.zeros(2, 5, 5, 5, 4)
    out, ws, plan, geom = cv.wgrad_args(a, b, (1, 3, 3), (1, 2, 2))
    assert geom.dtype == np.int32 and geom.size == 24
    assert list(geom[:17]) == [5, 9, 10, 16, 5, 5, 5, 4, 1, 3, 3, 1, 2, 2, 0, 1, 0]
    assert geom[17] == 2 and math.prod(b.shape[:4]) + plan["chunk_rows"] < 2 ** 31
    assert tuple(out.shape) == (1, 3, 3, 16, 4)
