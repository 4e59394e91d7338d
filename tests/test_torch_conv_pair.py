"""K1's two-output launch (``ops/convolution.py`` ``conv3d_pair``): an SE
block's first conv and its projection over one input in one pass.

On the CPU: the pair's plain route against two ``conv3d_plain`` calls, its
gradients against the two calls', the rule that chooses the fused blocks of
the served models (read from the models' modules on the meta device), an SE
block against the same block computed with two separate ``conv3d`` calls
here, and the host arrays of a two-output launch. On a card (marked
``cuda``, skipped without one): the kernel's two outputs against its twin at
the served models' fused shapes. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_conv_pair.py
"""

import pytest
import torch
import torch.nn.functional as F

from prostatemr_3d_cad_cspca_tpu_torch.models import blocks
from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1
from prostatemr_3d_cad_cspca_tpu_torch.ops import convolution as tconv
from prostatemr_3d_cad_cspca_tpu_torch.ops.normalization import global_spatial_mean
from port_support import CFG1, PROB, PROB_DENSE

KERNELS = [(1, 3, 3), (3, 3, 3), (1, 1, 1)]
STRIDES = [(1, 1, 1), (1, 2, 2), (2, 2, 2)]
DTYPES = [torch.float32, torch.bfloat16]


def _operands(nparts, ks, f, dtype, seed=0, spatial=(3, 6, 7), batch=2, cin=5):
    g = torch.Generator().manual_seed(seed)
    parts = [torch.randn(batch, *spatial, cin, generator=g).to(dtype) for _ in range(nparts)]
    k1 = torch.randn(*ks, nparts * cin, f // 4, generator=g) / 4
    k4 = torch.randn(*ks, nparts * cin, f, generator=g) / 4
    b1, b4 = torch.randn(f // 4, generator=g), torch.randn(f, generator=g)
    return parts, k1, b1, k4, b4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("st", STRIDES)
@pytest.mark.parametrize("ks", KERNELS)
@pytest.mark.parametrize("nparts", [1, 2, 6])
def test_pair_plain_route_is_two_plain_convs(nparts, ks, st, dtype):
    """The pair's outputs are the two convs' bits: the same fp32 sums a
    column, each rounded once to the dtype."""
    parts, k1, b1, k4, b4 = _operands(nparts, ks, 16, dtype, seed=nparts)
    y1, y4 = tconv.conv3d_pair(parts, k1, b1, k4, b4, st)
    assert y1.is_contiguous() and y4.is_contiguous() and y1.dtype == y4.dtype == dtype
    torch.testing.assert_close(y1, tconv.conv3d_plain(parts, k1.to(dtype), b1, st),
                               rtol=0, atol=0)
    torch.testing.assert_close(y4, tconv.conv3d_plain(parts, k4.to(dtype), b4, st),
                               rtol=0, atol=0)


@pytest.mark.parametrize("ks,st", [((1, 3, 3), (1, 2, 2)), ((3, 3, 3), (1, 1, 1)),
                                   ((1, 1, 1), (1, 1, 1))])
@pytest.mark.parametrize("nparts", [1, 3])
def test_pair_gradients_are_the_two_convs(nparts, ks, st):
    """fp32: the kernels', biases' and every part's gradients of a loss on
    both outputs are, to the bit, those through two separate K1 calls: each
    output takes K1's own backward."""
    ops = _operands(nparts, ks, 16, torch.float32, seed=3)
    weights = torch.randn(2)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (*ops[0], *ops[1:])]
        parts, (k1, b1, k4, b4) = leaves[:nparts], leaves[nparts:]
        y1, y4 = fn(parts, k1, b1, k4, b4)
        loss = weights[0] * (y1 * y1).sum() + weights[1] * (y4 * y4.tanh()).sum()
        return torch.autograd.grad(loss, leaves)

    fused = grads(lambda p, k1, b1, k4, b4: tconv.conv3d_pair(p, k1, b1, k4, b4, st))
    apart = grads(lambda p, k1, b1, k4, b4: (tconv.conv3d(p, k1, b1, st),
                                             tconv.conv3d(p, k4, b4, st)))
    for got, want in zip(fused, apart):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# the SE blocks whose first and projection convs fuse, per model and dtype
CFG1_BF16 = {"serse1", "serse2", "sersd2", "sersd1", "sersd0"}
LADDER_BF16 = {"sersp_1", "sersp_2", "sersp_3"}
CFG1_FP32 = {"serse1", "sersd1", "sersd0"}
MODELS = {"cfg1": dict(CFG1, dropout_mode="monte-carlo", dropout_rate=0.5), "prob": PROB,
          "prob_dense": PROB_DENSE}


@pytest.mark.parametrize("dtype,batch,name,want", [
    (torch.bfloat16, 32, "cfg1", CFG1_BF16),
    (torch.bfloat16, 32, "prob", CFG1_BF16 | LADDER_BF16),
    (torch.bfloat16, 32, "prob_dense", CFG1_BF16 | LADDER_BF16),
    (torch.float32, 64, "cfg1", CFG1_FP32)])
def test_the_rule_fuses_the_blocks_the_shapes_allow(dtype, batch, name, want, monkeypatch):
    """At the served batches (bf16 MC-4 requests of 8 volumes, the fp32
    gland's 64 windows) the rule fuses f = 16, 32, 64 in bf16 and 16, 32 in
    fp32 (fewer output-channel tiles in one call, no split-K), never the
    f = 128 and 256 blocks nor a block without a projection; a forward makes
    one pair call a fused block."""
    cfg = MODELS[name]
    model = M1(**cfg, summary=False, init_params=False, device="meta", dtype=dtype)
    fused, pairs = set(), []
    real = tconv.conv3d_pair
    monkeypatch.setattr(tconv, "conv3d_pair", lambda *a, **kw: pairs.append(1) or real(*a, **kw))
    for path, mod in model.net.named_modules():
        if isinstance(mod, blocks.SEResNetBottleNeck):
            def hook(mod, args, path=path):
                x = args[0]
                if mod.conv4 is not None and tconv.fuses(mod.conv1, mod.conv4, x):
                    fused.add(path.split(".")[-1])
            mod.register_forward_pre_hook(hook)
    x = torch.zeros(batch, *cfg["input_spatial_dims"], cfg["input_channels"], device="meta")
    with torch.no_grad():
        model.net.detect(x, rng=torch.Generator())
    assert fused == want
    assert len(pairs) == len(want)


def test_the_rule_reads_tiles_and_split_k():
    """Where the tiles do not fall (bf16 f = 128: 2 against 2), where the
    plan splits K (few output tiles), or f is no multiple of 8, two calls."""
    big = [(32, 20, 40, 40, 64)]
    assert tconv.pair_fuses(big, (3, 3, 3), (1, 1, 1), 16, 64, torch.bfloat16)
    assert not tconv.pair_fuses(big, (3, 3, 3), (1, 1, 1), 32, 128, torch.bfloat16)
    assert not tconv.pair_fuses(big, (3, 3, 3), (1, 1, 1), 16, 64, torch.float32)
    assert not tconv.pair_fuses([(1, 2, 4, 4, 64)], (3, 3, 3), (1, 1, 1), 16, 64,
                                torch.bfloat16)
    assert not tconv.pair_fuses(big, (3, 3, 3), (1, 1, 1), 3, 12, torch.bfloat16)
    assert not tconv.pair_fuses(big, (3, 3, 3), (1, 1, 1), 4, 16, torch.float64)


def _block_apart(blk, parts):
    """The SE block's forward with its first and projection convs as two
    separate ``conv3d`` calls."""
    def conv(c, x):
        x = x if isinstance(x, list) else [x]
        dt = c.cfg.dtype or torch.promote_types(x[0].dtype, c.kernel.dtype)
        return tconv.conv3d([p.to(dt) for p in x], c.kernel.to(dt), c.bias.float(), c.strides)

    h = blk.norm1(conv(blk.conv1, parts), lrelu=True)
    h = blk.norm2(conv(blk.conv2, h), lrelu=True)
    x_ = blk.norm3(conv(blk.conv3, h))
    residual = blk.norm4(conv(blk.conv4, parts))
    s = global_spatial_mean(x_).to(x_.dtype)
    s = torch.sigmoid(blk.se_conv7(F.leaky_relu(blk.se_conv6(s), 0.1)))
    return F.leaky_relu((x_ * s) * residual, 0.1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nparts,ks,st", [(1, (1, 3, 3), (1, 2, 2)), (2, (1, 3, 3), (1, 1, 1)),
                                          (3, (1, 1, 1), (1, 1, 1)), (1, (3, 3, 3), (1, 2, 2))])
def test_se_block_fused_is_the_block_apart(nparts, ks, st, dtype, monkeypatch):
    """An SE block (f = 16) whose rule fuses: its output, and in fp32 its
    parameters' gradients, are those of the block with two conv3d calls."""
    cfg = tconv.ConvConfig(dtype=dtype)
    blk = blocks.SEResNetBottleNeck(6 * nparts, 16, ks, st, 2, cfg)
    g = torch.Generator().manual_seed(nparts)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=g) / 4)
    parts = [torch.randn(2, 3, 8, 8, 6, generator=g).to(dtype) for _ in range(nparts)]
    assert tconv.fuses(blk.conv1, blk.conv4, parts)
    n = []
    real = tconv.conv3d_pair
    monkeypatch.setattr(tconv, "conv3d_pair", lambda *a, **kw: n.append(1) or real(*a, **kw))
    got = blk(parts if nparts > 1 else parts[0])
    want = _block_apart(blk, parts)
    assert len(n) == 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if dtype == torch.float32:
        gw = torch.randn(got.shape, generator=g)
        fused = torch.autograd.grad((got * gw).sum(), list(blk.parameters()))
        apart = torch.autograd.grad((want * gw).sum(), list(blk.parameters()))
        for a, b in zip(fused, apart):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_two_output_host_arrays(dtype):
    """meta[98] holds the first output's columns (0 with one output), the
    second output's pointer the last slot; a plan that splits K, a split
    that is no multiple of 8 and K2 are refused."""
    x = torch.empty(2, 4, 40, 40, 16, dtype=dtype, device="meta")
    k = torch.empty(1, 3, 3, 16, 20, dtype=dtype, device="meta")
    (y, y2), ws, plan, (ptrs, meta, _) = tconv.wgmma_args([x], k, None, (1, 1, 1), False, 16)
    assert ws is None and plan["splits"] == 1 and int(meta[98]) == 16
    assert y.shape == (2, 4, 40, 40, 16) and y2.shape == (2, 4, 40, 40, 4)
    assert ptrs.size == tconv.MAX_PARTS + 5
    _, _, _, (_, one, _) = tconv.wgmma_args([x], k, None, (1, 1, 1), False)
    assert int(one[98]) == 0 and (one[:98] == meta[:98]).all()
    with pytest.raises(ValueError):
        tconv.wgmma_args([x], k, None, (1, 1, 1), False, 12)
    small = torch.empty(1, 2, 4, 4, 64, dtype=dtype, device="meta")
    deep = torch.empty(3, 3, 3, 64, 80, dtype=dtype, device="meta")
    assert tconv.wgmma_plan([small.shape], deep.shape, (1, 1, 1), False,
                            dtype=dtype)["splits"] > 1
    with pytest.raises(ValueError):
        tconv.wgmma_args([small], deep, None, (1, 1, 1), False, 64)
    with pytest.raises(ValueError):
        tconv.wgmma_args([x], torch.empty(3, 3, 3, 20, 16, dtype=dtype, device="meta"),
                         None, (1, 2, 2), True, 8)


# ----------------------------------------------------------- on a card
# the served models' fused shapes (bf16 MC-4 requests: 32 volumes):
# level 0's 2-, 3- and 6-part stitches (q 4, f 16), serse1's stride-(1, 2, 2)
# pair (q 8, f 32) and serse2's and sersd2's f = 64 pairs at 3x3x3
L0, L1, L2 = (32, 20, 160, 160, 16), (32, 20, 80, 80, 32), (32, 20, 40, 40, 64)
CARD_CASES = [
    ((L0,) * 2, (1, 3, 3), (1, 1, 1), 16),
    ((L0,) * 3, (1, 3, 3), (1, 1, 1), 16),
    ((L0,) * 6, (1, 3, 3), (1, 1, 1), 16),
    ((L0,), (1, 3, 3), (1, 2, 2), 32),
    ((L1,), (3, 3, 3), (1, 2, 2), 64),
    ((L2,) * 3, (3, 3, 3), (1, 1, 1), 64),
]
CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}  # K1's own (test_torch_kernels)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shapes,ks,st,f", CARD_CASES)
def test_card_pair_kernel_matches_plain(shapes, ks, st, f, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(f)
    parts = [torch.randn(s, generator=g, device="cuda").to(dtype) for s in shapes]
    cin = sum(s[-1] for s in shapes)
    scale = (cin * ks[0] * ks[1] * ks[2]) ** 0.5
    k1 = torch.randn(*ks, cin, f // 4, generator=g, device="cuda") / scale
    k4 = torch.randn(*ks, cin, f, generator=g, device="cuda") / scale
    b1 = torch.randn(f // 4, generator=g, device="cuda")
    b4 = torch.randn(f, generator=g, device="cuda")
    n0, n1 = tconv.conv3d_pair.launches, tconv.conv3d.launches
    y1, y4 = tconv.conv3d_pair(parts, k1, b1, k4, b4, st)
    torch.cuda.synchronize()
    assert tconv.conv3d_pair.launches == n0 + 1 and tconv.conv3d.launches == n1
    want4, want1 = tconv.conv3d_pair_plain(parts, torch.cat([k4, k1], 4).to(dtype),
                                            torch.cat([b4, b1]), f, st)
    for got, want in ((y1, want1), (y4, want4)):
        assert got.shape == want.shape and got.dtype == dtype
        err = ((got.float() - want.float()).abs() / want.float().abs().clamp(min=1.0)).max()
        assert float(err) <= CARD_TOL[dtype]
    again = tconv.conv3d_pair(parts, k1, b1, k4, b4, st)
    assert torch.equal(again[0], y1) and torch.equal(again[1], y4)
