"""K1-K5 against their plain PyTorch twins on a CUDA card.

The kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a card. This file imports no JAX, so it also runs on a
machine that has only PyTorch; there, skip the JAX-pinning conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import math

import pytest
import torch

from prostatemr_3d_cad_cspca_tpu_torch.ops import convolution as tconv
from prostatemr_3d_cad_cspca_tpu_torch.ops import gemm as tgemm
from prostatemr_3d_cad_cspca_tpu_torch.ops import normalization as tnorm
from prostatemr_3d_cad_cspca_tpu_torch.probes.gemm_rate import operands
from chip_smoke import BranchReplay, _conv_fp64  # fp64 references

CONV_CASES = [  # (kernel, stride) pairs of the M1 path
    ((1, 3, 3), (1, 1, 1)), ((1, 3, 3), (1, 2, 2)), ((3, 3, 3), (1, 1, 1)),
    ((3, 3, 3), (1, 2, 2)), ((3, 3, 3), (2, 2, 2)), ((1, 1, 1), (1, 1, 1)),
]
CONVT_CASES = [((3, 3, 3), (2, 2, 2)), ((3, 3, 3), (1, 2, 2)),
               ((1, 3, 3), (1, 2, 2))]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# fp32: the kernel's 3xTF32 products (~2**-22 relative each) and cuDNN's
# fp32 ones differ by that and by summation order; bf16: both round one fp32
# result, so at most one bf16 step apart.
CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


# the names of the kernel's two ways in, A (a part: a TMA or a staged box)
# and B (the weights: 16-byte loads, bf16 by TMA or cp.async and fp32 by
# cp.async, or element by element), in both dtypes (csrc/conv3d_wgmma.cu)
A_ROUTES = ("tma", "staged")
B_ROUTES = ("vector", "scalar")


def _routes(parts, kernel, st=(1, 1, 1), transposed=False):
    """(each part's route, the weights' route) of the kernel in the parts'
    dtype, from the plan the wrapper hands it."""
    _, _, plan, (_, meta, _) = tconv.wgmma_args(parts, kernel, None, st, transposed)
    return [A_ROUTES[0 if t else 1] for t in plan["tma"]], B_ROUTES[0 if meta[14] else 1]


def _card_err(got, ref):
    d = (got.float() - ref.float()).abs()
    return float((d / ref.float().abs().clamp(min=1.0)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ks,st", CONV_CASES)
def test_card_conv3d_kernel_matches_plain(cuda_device, ks, st, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    parts = [torch.randn(2, 5, 9, 10, c, generator=g, device=cuda_device).to(dtype)
             for c in (3, 16)]
    kernel = (torch.randn(*ks, 19, 33, generator=g, device=cuda_device) / 8).to(dtype)
    bias = torch.randn(33, generator=g, device=cuda_device)
    n0 = tconv.conv3d.launches
    got = tconv.conv3d(parts, kernel, bias, st)
    torch.cuda.synchronize()
    assert tconv.conv3d.launches == n0 + 1
    assert _card_err(got, tconv.conv3d_plain(parts, kernel, bias, st)) <= CARD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ks,st", CONVT_CASES)
def test_card_conv3d_transpose_kernel_matches_plain(cuda_device, ks, st, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(2, 5, 9, 10, 24, generator=g, device=cuda_device).to(dtype)
    kernel = (torch.randn(*ks, 7, 24, generator=g, device=cuda_device) / 8).to(dtype)
    bias = torch.randn(7, generator=g, device=cuda_device)
    got = tconv.conv3d_transpose(x, kernel, bias, st)
    ref = tconv.conv3d_transpose_plain(x, kernel, bias, st)
    torch.cuda.synchronize()
    assert _card_err(got, ref) <= CARD_TOL[dtype]


# The kernel's other routes: narrow cout (scalar weight loads below a 16-byte
# chunk, n8 tiles), a misaligned part (a staged box), split-K. Split-K does
# not loosen the tolerance: the partials stay fp32 and the reduce rounds
# their fixed-order sum once, so the kernel and its twin still each round one
# fp32 sum of the same products.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cout", [1, 2, 4, 8])
def test_card_conv3d_narrow_cout(cuda_device, cout, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(2, 5, 9, 10, 16, generator=g, device=cuda_device).to(dtype)
    kernel = (torch.randn(3, 3, 3, 16, cout, generator=g, device=cuda_device) / 8).to(dtype)
    bias = torch.randn(cout, generator=g, device=cuda_device)
    chunk = 16 // x.element_size()
    assert _routes([x], kernel)[1] == B_ROUTES[0 if cout % chunk == 0 else 1]
    got = tconv.conv3d([x], kernel, bias)
    ref = tconv.conv3d_plain([x], kernel, bias)
    torch.cuda.synchronize()
    assert _card_err(got, ref) <= CARD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_conv3d_misaligned_part_takes_the_staged_route(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(4)
    shape = (2, 5, 9, 10, 16)
    flat = torch.randn(math.prod(shape) + 1, generator=g, device=cuda_device)
    shifted = flat.to(dtype)[1:].view(shape)  # contiguous, one element off
    aligned = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    kernel = (torch.randn(3, 3, 3, 32, 24, generator=g, device=cuda_device) / 8).to(dtype)
    bias = torch.randn(24, generator=g, device=cuda_device)
    parts = [aligned, shifted]
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    assert _routes(parts, kernel, (1, 2, 2)) == (list(A_ROUTES), B_ROUTES[0])
    got = tconv.conv3d(parts, kernel, bias, (1, 2, 2))
    ref = tconv.conv3d_plain(parts, kernel, bias, (1, 2, 2))
    torch.cuda.synchronize()
    assert _card_err(got, ref) <= CARD_TOL[dtype]


@pytest.mark.cuda
def test_card_fp32_deepest_stitch_holds_the_fp32_limit(cuda_device):
    """The path's deepest K (3x3x3 over 128 + 128 channels, K = 6,912): the
    3xTF32 kernel against its fp32 twin and against the fp64 product."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    parts = [torch.randn(2, 10, 20, 20, 128, generator=g, device=cuda_device)
             for _ in range(2)]
    kernel = torch.randn(3, 3, 3, 256, 128, generator=g, device=cuda_device) / 6912 ** 0.5
    bias = 0.1 * torch.randn(128, generator=g, device=cuda_device)
    got = tconv.conv3d(parts, kernel, bias)
    ref = tconv.conv3d_plain(parts, kernel, bias)
    exact = _conv_fp64(parts, kernel, bias, (1, 1, 1))
    torch.cuda.synchronize()
    assert _card_err(got, ref) <= 2e-4
    assert _card_err(got, exact) <= 2e-4


# The probabilistic ladder's shapes at cfg1 width (latent dims 3, 2, 1, 0):
# dec_hi takes [z, features], cin 259 / 130 / 65, none a multiple of the
# 16-byte chunk, so K2's box is staged and its weights load element by
# element; mu_logsig is
# a 1x1x1 conv to 2 x dims channels; a dense-skip ladder's stage-0 stitch
# has six parts.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xshape,kshape,st", [
    ((2, 5, 10, 10, 259), (3, 3, 3, 128, 259), (2, 2, 2)),
    ((2, 20, 40, 40, 65), (3, 3, 3, 32, 65), (1, 2, 2)),
])
def test_card_conv3d_transpose_scalar_route(cuda_device, xshape, kshape, st, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(12)
    x = torch.randn(xshape, generator=g, device=cuda_device).to(dtype)
    kernel = (torch.randn(kshape, generator=g, device=cuda_device)
              / (27 * kshape[4]) ** 0.5).to(dtype)
    bias = torch.randn(kshape[3], generator=g, device=cuda_device)
    assert _routes([x], kernel, st, True) == ([A_ROUTES[1]], B_ROUTES[1])
    got = tconv.conv3d_transpose(x, kernel, bias, st)
    ref = tconv.conv3d_transpose_plain(x, kernel, bias, st)
    torch.cuda.synchronize()
    assert _card_err(got, ref) <= CARD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths,ks,cout", [
    ((16,) * 6, (1, 3, 3), 4),            # sersp_3's conv1 at cfg1 width
    ((8, 5, 16, 3, 8, 4), (3, 3, 3), 24),  # mixed widths and gather routes
    ((256,), (1, 1, 1), 6),               # mu_logsig_0
])
def test_card_conv3d_six_parts_and_narrow_heads(cuda_device, widths, ks, cout, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(13)
    parts = [torch.randn(2, 5, 20, 20, c, generator=g, device=cuda_device).to(dtype)
             for c in widths]
    kernel = (torch.randn(*ks, sum(widths), cout, generator=g, device=cuda_device)
              / (math.prod(ks) * sum(widths)) ** 0.5).to(dtype)
    bias = torch.randn(cout, generator=g, device=cuda_device)
    got = tconv.conv3d(parts, kernel, bias)
    ref = tconv.conv3d_plain(parts, kernel, bias)
    torch.cuda.synchronize()
    assert _card_err(got, ref) <= CARD_TOL[dtype]


SPLIT_CASES = [  # (part shapes, kernel, strides, transposed): split-K in both dtypes'
    # plans (fp32's tiles stop at N 64 and one block runs an SM)
    ([(2, 5, 10, 10, 256)], (3, 3, 3, 256, 128), (1, 1, 1), False),
    ([(1, 5, 10, 10, 128)] * 2, (3, 3, 3, 256, 64), (1, 1, 1), False),
    ([(2, 3, 5, 5, 256)], (3, 3, 3, 128, 256), (2, 2, 2), True),
]


def _split_case(device, shapes, kshape, transposed, seed, dtype):
    g = torch.Generator(device=device).manual_seed(seed)
    parts = [torch.randn(s, generator=g, device=device).to(dtype) for s in shapes]
    fan_in = math.prod(kshape[:3]) * kshape[4 if transposed else 3]
    kernel = (torch.randn(kshape, generator=g, device=device) / fan_in ** 0.5).to(dtype)
    bias = torch.randn(kshape[3 if transposed else 4], generator=g, device=device)
    return parts, kernel, bias


def _split_run(parts, kernel, bias, st, transposed):
    if transposed:
        return (tconv.conv3d_transpose(parts[0], kernel, bias, st),
                tconv.conv3d_transpose_plain(parts[0], kernel, bias, st))
    return tconv.conv3d(parts, kernel, bias, st), tconv.conv3d_plain(parts, kernel, bias, st)


def _splits(parts, kernel, st, transposed):
    shapes = [tuple(p.shape) for p in parts]
    return tconv.wgmma_plan(shapes, tuple(kernel.shape), st, transposed,
                            dtype=parts[0].dtype)["splits"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes,kshape,st,transposed", SPLIT_CASES)
def test_card_split_k_matches_plain(cuda_device, shapes, kshape, st, transposed, dtype):
    parts, kernel, bias = _split_case(cuda_device, shapes, kshape, transposed, 5, dtype)
    assert _splits(parts, kernel, st, transposed) > 1
    got, ref = _split_run(parts, kernel, bias, st, transposed)
    torch.cuda.synchronize()
    assert _card_err(got, ref) <= CARD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes,kshape,st,transposed", SPLIT_CASES)
def test_card_split_k_is_bit_reproducible(cuda_device, shapes, kshape, st, transposed, dtype):
    parts, kernel, bias = _split_case(cuda_device, shapes, kshape, transposed, 6, dtype)
    first = _split_run(parts, kernel, bias, st, transposed)[0]
    second = _split_run(parts, kernel, bias, st, transposed)[0]
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# K1/K2 on wgmma (csrc/conv3d_wgmma.cu) at each of its routes in each dtype:
# parts by TMA (a 16-byte voxel stride: bf16 16, 64 channels; fp32 also 4)
# and staged (bf16 3, 4, 19; fp32 3, 5, 19; K2 at the ladder's 65, 130,
# 259), six parts (fp32: 8, 5, 16, 3, 8, 4 mixes both routes), K2 at both
# strides, flat 1x1x1, narrow (1, 2, 4: element weights below a 16-byte
# chunk) and wide cout; each call must take the wgmma kernel.
WGMMA_CASES = [  # (part widths, spatial, kernel, strides, transposed)
    ((16, 16), (3, 12, 20), (1, 3, 3, 32, 16), (1, 1, 1), False),
    ((3,), (3, 12, 20), (1, 3, 3, 3, 16), (1, 1, 1), False),
    ((4,), (4, 9, 10), (3, 3, 3, 4, 4), (1, 1, 1), False),
    ((19, 64), (3, 7, 9), (3, 3, 3, 83, 8), (1, 2, 2), False),
    ((16,) * 6, (2, 9, 18), (1, 3, 3, 96, 4), (1, 1, 1), False),
    ((64,), (5, 7, 9), (3, 3, 3, 64, 128), (2, 2, 2), False),
    ((256,), (5, 10, 10), (1, 1, 1, 256, 6), (1, 1, 1), False),
    ((259,), (3, 5, 5), (3, 3, 3, 128, 259), (2, 2, 2), True),
    ((130,), (3, 5, 5), (3, 3, 3, 64, 130), (2, 2, 2), True),
    ((65,), (3, 5, 6), (3, 3, 3, 32, 65), (1, 2, 2), True),
    ((32,), (2, 9, 10), (1, 3, 3, 16, 32), (1, 2, 2), True),
]
FP32_WGMMA_CASES = [  # fp32's own boundaries: 4 and 5 channels, cout 1 and 2
    ((5,), (3, 9, 10), (1, 3, 3, 5, 16), (1, 1, 1), False),
    ((8, 5, 16, 3, 8, 4), (2, 5, 7), (3, 3, 3, 44, 6), (1, 1, 1), False),
    ((16,), (4, 12, 20), (1, 1, 1, 16, 1), (1, 1, 1), False),
    ((16,), (4, 12, 20), (1, 1, 1, 16, 2), (1, 1, 1), False),
    ((4,), (3, 8, 10), (3, 3, 3, 16, 4), (1, 1, 1), True),
    ((1,), (3, 8, 10), (1, 1, 1, 16, 1), (1, 1, 1), True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("widths,spatial,kshape,st,transposed,dtype",
                         [(*c, torch.bfloat16) for c in WGMMA_CASES]
                         + [(*c, torch.float32) for c in WGMMA_CASES + FP32_WGMMA_CASES])
def test_card_wgmma_routes_match_plain(cuda_device, widths, spatial, kshape, st,
                                       transposed, dtype):
    shapes = [(2, *spatial, c) for c in widths]
    parts, kernel, bias = _split_case(cuda_device, shapes, kshape, transposed, 21, dtype)
    plan = tconv.wgmma_plan(shapes, kshape, st, transposed, dtype=dtype)
    vec = 16 // parts[0].element_size()
    assert plan["tma"] == [c % vec == 0 for c in widths]
    wrapper = tconv.conv3d_transpose if transposed else tconv.conv3d
    before = wrapper.launches
    got, ref = _split_run(parts, kernel, bias, st, transposed)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1 and tconv.kernel_route(dtype) == "wgmma"
    assert _card_err(got, ref) <= CARD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("lrelu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 12, 300])
def test_card_instance_norm_kernels_match_plain(cuda_device, c, dtype, lrelu):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = (torch.randn(2, 6, 17, 33, c, generator=g, device=cuda_device) * 3 + 1).to(dtype)
    scale = torch.randn(c, generator=g, device=cuda_device)
    bias = torch.randn(c, generator=g, device=cuda_device)
    stats = tnorm.in_stats(x)
    assert _card_err(stats, tnorm.in_stats_plain(x)) <= 1e-4
    got = tnorm.in_apply(x, stats, scale, bias, lrelu)
    ref = tnorm.in_apply_plain(x, stats, scale, bias, lrelu)
    torch.cuda.synchronize()
    assert _card_err(got, ref) <= CARD_TOL[dtype]


# K3 at the ten distinct shapes of one cfg1 forward at batch 2 (the serve
# path, bf16), and at channel counts that take each of the kernel's routes:
# C 4 (one vector holds two voxels), 8 (one or two vectors a voxel), 300
# (bf16: scalar, wider than a block; fp32: 75 vectors a voxel).
IN_PATH_SHAPES = [(2, 20, 160, 160, 16), (2, 20, 160, 160, 4), (2, 20, 80, 80, 32),
                  (2, 20, 80, 80, 8), (2, 20, 40, 40, 64), (2, 20, 40, 40, 16),
                  (2, 10, 20, 20, 128), (2, 10, 20, 20, 32), (2, 5, 10, 10, 256),
                  (2, 5, 10, 10, 64)]


def _in_x(device, shape, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=device) * 2 + 0.5).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", IN_PATH_SHAPES)
def test_card_in_stats_at_the_path_shapes(cuda_device, shape):
    x = _in_x(cuda_device, shape, torch.bfloat16, 7)
    n0 = tnorm.in_stats.launches
    got = tnorm.in_stats(x)
    torch.cuda.synchronize()
    assert tnorm.in_stats.launches == n0 + 1
    assert _card_err(got, tnorm.in_stats_plain(x)) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [4, 8, 300])
def test_card_in_stats_routes_match_plain(cuda_device, c, dtype):
    x = _in_x(cuda_device, (2, 7, 19, 24, c), dtype, 8)
    plan = tnorm.in_stats_plan(2, 7 * 19 * 24, c, x.element_size())
    assert plan["route"] == ("scalar" if (c, dtype) == (300, torch.bfloat16) else "vector")
    got = tnorm.in_stats(x)
    torch.cuda.synchronize()
    assert _card_err(got, tnorm.in_stats_plain(x)) <= 1e-4


# K4 at the same shapes and routes, both dtypes, with and without LReLU
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", IN_PATH_SHAPES)
def test_card_in_apply_at_the_path_shapes(cuda_device, shape, dtype):
    x = _in_x(cuda_device, shape, dtype, 12)
    c = shape[-1]
    scale = 1 + 0.1 * _in_x(cuda_device, (c,), torch.float32, 13)
    bias = 0.1 * _in_x(cuda_device, (c,), torch.float32, 14)
    stats = tnorm.in_stats_plain(x)
    for lrelu in (False, True):
        n0 = tnorm.in_apply.launches
        got = tnorm.in_apply(x, stats, scale, bias, lrelu)
        torch.cuda.synchronize()
        assert tnorm.in_apply.launches == n0 + 1
        assert _card_err(got, tnorm.in_apply_plain(x, stats, scale, bias, lrelu)) <= \
            CARD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [4, 8, 300])
def test_card_in_apply_routes_match_plain(cuda_device, c, dtype):
    x = _in_x(cuda_device, (2, 7, 19, 24, c), dtype, 15)
    plan = tnorm.in_apply_plan(2, 7 * 19 * 24, c, x.element_size())
    assert plan["route"] == ("scalar" if (c, dtype) == (300, torch.bfloat16) else "vector")
    scale, bias = torch.ones(c, device=cuda_device), torch.zeros(c, device=cuda_device)
    stats = tnorm.in_stats_plain(x)
    got = tnorm.in_apply(x, stats, scale, bias, True)
    torch.cuda.synchronize()
    assert _card_err(got, tnorm.in_apply_plain(x, stats, scale, bias, True)) <= CARD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_in_apply_misaligned_base_takes_the_scalar_route(cuda_device, dtype):
    shape = (2, 5, 9, 10, 16)
    flat = _in_x(cuda_device, (math.prod(shape) + 1,), dtype, 16)
    shifted = flat[1:].view(shape)  # contiguous, one element off 16 bytes
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    assert tnorm.in_apply_plan(2, math.prod(shape[1:4]), 16, shifted.element_size(),
                               aligned=False)["route"] == "scalar"
    scale = torch.linspace(0.5, 1.5, 16, device=cuda_device)
    bias = torch.linspace(-0.2, 0.2, 16, device=cuda_device)
    stats = tnorm.in_stats_plain(shifted)
    got = tnorm.in_apply(shifted, stats, scale, bias, True)
    torch.cuda.synchronize()
    assert _card_err(got, tnorm.in_apply_plain(shifted, stats, scale, bias, True)) <= \
        CARD_TOL[dtype]


# x on the vector route, but stats, scale and bias one float off 16 bytes:
# the coefficients take scalar loads instead of float4s.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_in_apply_misaligned_coefficients(cuda_device, dtype):
    shape, c = (2, 5, 9, 10, 16), 16
    x = _in_x(cuda_device, shape, dtype, 17)
    assert tnorm.in_apply_plan(2, math.prod(shape[1:4]), c, x.element_size())["route"] == \
        "vector"
    stats = torch.empty(2 * 2 * c + 1, device=cuda_device)[1:].view(2, 2, c)
    stats.copy_(tnorm.in_stats_plain(x))
    scale = (1 + 0.1 * _in_x(cuda_device, (c + 1,), torch.float32, 18))[1:]
    bias = (0.1 * _in_x(cuda_device, (c + 1,), torch.float32, 19))[1:]
    assert all(t.data_ptr() % 16 != 0 for t in (stats, scale, bias))
    got = tnorm.in_apply(x, stats, scale, bias, True)
    torch.cuda.synchronize()
    assert _card_err(got, tnorm.in_apply_plain(x, stats, scale, bias, True)) <= CARD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_in_stats_is_bit_reproducible(cuda_device, dtype):
    x = _in_x(cuda_device, (2, 20, 40, 40, 64), dtype, 9)
    first = tnorm.in_stats(x)
    second = tnorm.in_stats(x)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_in_stats_misaligned_base_takes_the_scalar_route(cuda_device, dtype):
    shape = (2, 5, 9, 10, 16)
    flat = _in_x(cuda_device, (math.prod(shape) + 1,), dtype, 10)
    shifted = flat[1:].view(shape)  # contiguous, one element off 16 bytes
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    spatial = math.prod(shape[1:4])
    assert tnorm.in_stats_plan(2, spatial, 16, shifted.element_size(),
                               aligned=False)["route"] == "scalar"
    got = tnorm.in_stats(shifted)
    torch.cuda.synchronize()
    assert _card_err(got, tnorm.in_stats_plain(shifted)) <= 1e-4


# K5: the probe shapes, ragged M/N/K edges, one tile and one element
GEMM_CASES = [(640, 1152, 128, 3), (2560, 144, 128, 2), (5120, 1152, 256, 1),
              (100, 40, 24, 3), (130, 16, 72, 4), (1, 8, 8, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,iters", GEMM_CASES)
def test_card_gemm_loop_kernel_matches_plain(cuda_device, m, k, n, iters):
    a, w = operands(m, k, n, cuda_device)
    n0 = tgemm.gemm_loop.launches
    got = tgemm.gemm_loop(a, w, iters)
    torch.cuda.synchronize()
    assert tgemm.gemm_loop.launches == n0 + 1
    assert _card_err(got, tgemm.gemm_loop_plain(a, w, iters)) <= 2.0 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("a_shape,w_shape,dtype", [
    ((16, 12), (12, 8), torch.bfloat16), ((16, 8), (8, 12), torch.bfloat16),
    ((16, 8), (8, 8), torch.float32)])
def test_card_gemm_loop_refuses_what_it_does_not_take(cuda_device, a_shape, w_shape, dtype):
    a = torch.zeros(a_shape, dtype=dtype, device=cuda_device)
    w = torch.zeros(w_shape, dtype=dtype, device=cuda_device)
    with pytest.raises(ValueError):
        tgemm.gemm_loop(a, w, 1)


# K5 where gemm_plan splits the tiles' steps over the card (the partials'
# fixed-order reduce), at the probe's own iteration counts, and at K = 144
# (a last slab of one 16-deep step)
GEMM_SPLIT_CASES = [(640, 1152, 128, 200), (640, 144, 128, 100), (2560, 1152, 256, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,iters", GEMM_SPLIT_CASES)
def test_card_gemm_loop_split_matches_plain(cuda_device, m, k, n, iters):
    assert tgemm.gemm_plan(m, k, n, iters)["split"]
    a, w = operands(m, k, n, cuda_device, seed=m + k + n)
    got = tgemm.gemm_loop(a, w, iters)
    torch.cuda.synchronize()
    assert _card_err(got, tgemm.gemm_loop_plain(a, w, iters)) <= 2.0 ** -7


@pytest.mark.cuda
def test_card_gemm_loop_split_is_bit_reproducible(cuda_device):
    a, w = operands(640, 1152, 128, cuda_device, seed=3)
    first = tgemm.gemm_loop(a, w, 200)
    second = tgemm.gemm_loop(a, w, 200)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# K6 at the weight-gradient roles of the M1 path: (A's shape, kernel,
# strides, B's channels); B's grid is A's SAME output. K1's role: A an input
# part, B the output gradient; K2's: A the fine grid's gradient, B the coarse
# input (the (1,2,2) and (2,2,2) cases). The cases reach every tile width of
# each dtype (ops/convolution.py WGRAD_TILES_N: N 8 for CB 1, 2, 4, 8; 16;
# 32; 64; 128 in bf16 for CB 70 and two tiles of 128 (bf16) or four of 64
# for 256), taps split over blocks (CA 256 at 3x3x3), the flat 1x1x1 route,
# and both routes of A and B (wgrad_routes): staged for the stem's CA 3,
# CA 33, bf16's CA 12 and 4, CB 1, 2 (and bf16's 4); TMA for the rest. fp32:
# 3xTF32 sums in another order than the twin's matmul; bf16: one rounding of
# fp32 sums.
WGRAD_CASES = [((2, 5, 9, 10, 3), (1, 3, 3), (1, 1, 1), 16),
               ((2, 5, 9, 10, 16), (1, 3, 3), (1, 2, 2), 4),
               ((2, 5, 9, 10, 16), (1, 3, 3), (1, 2, 2), 8),
               ((2, 6, 8, 10, 12), (3, 3, 3), (2, 2, 2), 70),
               ((2, 4, 6, 6, 33), (3, 3, 3), (1, 1, 1), 1),
               ((1, 3, 4, 4, 256), (3, 3, 3), (1, 1, 1), 256),
               ((2, 8, 24, 24, 16), (1, 3, 3), (1, 1, 1), 16),
               ((2, 8, 24, 24, 16), (1, 1, 1), (1, 1, 1), 16),
               ((2, 8, 24, 24, 16), (1, 1, 1), (1, 1, 1), 2),
               ((2, 4, 6, 6, 4), (3, 3, 3), (1, 1, 1), 4),
               ((2, 6, 12, 12, 32), (1, 3, 3), (1, 1, 1), 32),
               ((2, 5, 9, 10, 40), (1, 1, 1), (1, 1, 1), 16),
               ((2, 10, 20, 20, 32), (3, 3, 3), (1, 2, 2), 64)]


def _wgrad_operands(device, ashape, ks, st, cb, dtype, seed=1):
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(ashape, generator=g, device=device).to(dtype)
    out = [tconv.same_pads(n, k, s)[0] for n, k, s in zip(ashape[1:4], ks, st)]
    b = torch.randn((ashape[0], *out, cb), generator=g, device=device).to(dtype)
    return a, b


def _wgrad_err(got, ref):
    # an element sums every row's product: its rounding scales with the
    # output's largest sums, so the error is taken against that
    return float((got.float() - ref.float()).abs().max()) / max(1.0, float(ref.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ashape,ks,st,cb", WGRAD_CASES)
def test_card_conv3d_wgrad_matches_plain_and_reruns_bit_equal(cuda_device, ashape, ks, st,
                                                              cb, dtype):
    a, b = _wgrad_operands(cuda_device, ashape, ks, st, cb, dtype)
    n0 = tconv.conv3d_wgrad.launches
    got = tconv.conv3d_wgrad(a, b, ks, st)
    again = tconv.conv3d_wgrad(a, b, ks, st)
    torch.cuda.synchronize()
    assert tconv.conv3d_wgrad.launches == n0 + 2
    assert got.dtype == dtype and tuple(got.shape) == (*ks, ashape[-1], cb)
    ref = tconv.conv3d_wgrad_plain(a, b, ks, st)
    assert _wgrad_err(got, ref) <= CARD_TOL[dtype]
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_conv3d_wgrad_misaligned_base_takes_a_narrower_route(cuda_device, dtype):
    """A and B that start off the 16-byte grid (contiguous views one element
    into their storage) take the staged route; aligned, TMA."""
    a0, b0 = _wgrad_operands(cuda_device, (2, 5, 9, 10, 16), (1, 3, 3), (1, 2, 2), 16, dtype)
    a = torch.empty(a0.numel() + 1, dtype=dtype, device=cuda_device)[1:].view(a0.shape)
    b = torch.empty(b0.numel() + 1, dtype=dtype, device=cuda_device)[1:].view(b0.shape)
    a.copy_(a0)
    b.copy_(b0)
    assert tconv.wgrad_routes(a, b) == ("staged", "staged")
    assert tconv.wgrad_routes(a0, b0) == ("tma", "tma")
    got = tconv.conv3d_wgrad(a, b, (1, 3, 3), (1, 2, 2))
    vec = tconv.conv3d_wgrad(a0, b0, (1, 3, 3), (1, 2, 2))
    torch.cuda.synchronize()
    ref = tconv.conv3d_wgrad_plain(a0, b0, (1, 3, 3), (1, 2, 2))
    assert _wgrad_err(got, ref) <= CARD_TOL[dtype] and _wgrad_err(vec, ref) <= CARD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_conv3d_wgrad_level0_against_fp64(cuda_device, dtype):
    """The cfg1 stem block's (1,3,3) gradient at level 0 (2 x 20 x 160 x 160
    x 16, 1,024,000 rows over 263 bf16 / 176 fp32 chunks) against the fp64
    product of the same operands: fp32 within 1e-5 of the output's largest
    |value| (3xTF32's products are 2^-22 relative, its chains promoted, and
    the sums of ~5k rows a chunk reduced in order: ~1e-7 expected), bf16
    within its one rounding (2^-8 of it)."""
    a, b = _wgrad_operands(cuda_device, (2, 20, 160, 160, 16), (1, 3, 3), (1, 1, 1), 16,
                           dtype, seed=3)
    got = tconv.conv3d_wgrad(a, b, (1, 3, 3))
    exact = tconv.conv3d_wgrad_plain(a.double(), b.double(), (1, 3, 3))
    torch.cuda.synchronize()
    err = float((got.double() - exact).abs().max()) / float(exact.abs().max())
    assert err <= {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ks,st,sp", [((1, 3, 3), (1, 2, 2), (5, 9, 10)),
                                      ((3, 3, 3), (2, 2, 2), (5, 5, 11))])
def test_card_data_gradient_at_extents_that_are_not_output_times_stride(cuda_device, ks, st,
                                                                        sp, dtype):
    """K1's input gradient where n != o * s, on the card: K2 to extent o * s,
    cropped (ops/convolution.py dgrad_crop); against torch autograd of the
    plain twin on the CPU in fp64 (on the dtype's values), |diff| / max(1,
    |ref|) at the card tolerance."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, *sp, 5, generator=g).to(dtype).float()
    k = (torch.randn(*ks, 5, 6, generator=g) / (5 * math.prod(ks)) ** 0.5).to(dtype).float()
    out = tuple(-(-n // s) for n, s in zip(sp, st))
    gy = torch.randn(2, *out, 6, generator=g).to(dtype).float()
    x64 = x.double().requires_grad_()
    (want,) = torch.autograd.grad(tconv.conv3d_plain([x64], k.double(), None, st), [x64],
                                  gy.double())
    xc = x.to(cuda_device, dtype).requires_grad_()
    n_k2 = tconv.conv3d_transpose.launches
    y = tconv.conv3d([xc], k.to(cuda_device, dtype), None, st)
    (got,) = torch.autograd.grad(y, [xc], gy.to(cuda_device, dtype))
    torch.cuda.synchronize()
    assert tconv.conv3d_transpose.launches == n_k2 + 1
    assert tuple(got.shape) == tuple(x.shape) and got.dtype == dtype
    assert _card_err(got.cpu(), want) <= CARD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("lrelu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 4, 8, 12, 16, 65, 300])
def test_card_in_backward_matches_plain_and_reruns_bit_equal(cuda_device, c, dtype, lrelu):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = (torch.randn(2, 5, 9, 10, c, generator=g, device=cuda_device) * 2 + 0.5).to(dtype)
    gy = torch.randn(x.shape, generator=g, device=cuda_device).to(dtype)
    scale = 1 + 0.1 * torch.randn(c, generator=g, device=cuda_device)
    bias = 0.1 * torch.randn(c, generator=g, device=cuda_device)
    stats = tnorm.in_stats(x)
    n0 = tnorm.in_backward.launches
    dx, sums = tnorm.in_backward(x, gy, stats, scale, bias, lrelu)
    dx2, sums2 = tnorm.in_backward(x, gy, stats, scale, bias, lrelu)
    torch.cuda.synchronize()
    assert tnorm.in_backward.launches == n0 + 2
    rdx, rsums = tnorm.in_backward_plain(x, gy, stats, scale, bias, lrelu)
    assert dx.dtype == dtype and _card_err(dx, rdx) <= CARD_TOL[dtype]
    assert _card_err(sums, rsums) <= 1e-4
    assert torch.equal(dx, dx2) and torch.equal(sums, sums2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_autograd_through_the_kernels_matches_the_cpu(cuda_device, dtype):
    """One backward of a tiny M1 on the card (K1/K2 data gradients, K6, K7)
    against the same module's backward on the CPU's plain twins. Parameters
    are redrawn (instance-norm biases non-zero), so no SE squeeze sits at
    an LReLU's kink. The leaves compared are those whose gradient is not 0
    (|g| >= 1e-2 on the CPU in fp32): the conv biases ahead of an instance
    norm have an exact gradient of 0 and carry rounding alone (up to 1.5e-3
    apart in fp32 on an H100, card kernels or card torch ops alike). fp32:
    each within 1e-3 of its largest |gradient| (or of 1) from the same
    backward in fp64 on the CPU that takes the card's side at every kink
    (chip_smoke.BranchReplay): an LReLU input within rounding of 0 takes
    slope 1 on one device and 0.1 on the other, and one such element moves
    a leaf of this tiny model by up to 10 %. So the card and the CPU in fp32
    may take different sides at a few elements only (at most 8), each
    within 1e-5 of its tensor's largest |value| of its kink; and every leaf
    that no such element reaches (its fp64 gradients on the card's sides
    and on the CPU's within 1e-4) is also held to the CPU's fp32 gradient
    within 1e-3. bf16 rounds every
    activation, and the CPU's torch ops round elsewhere than the card's, so
    single leaves of the tiny model move by up to 40 % between two correct
    bf16 runs: the card's bf16 gradients are held to the card's fp32 ones,
    all leaves together, at a relative L2 error of 0.2."""
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1

    kw = dict(filters=(4, 8, 12, 16, 24), se_reduction=(2,) * 5, summary=False,
              strides=((1, 1, 1), (1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2)))
    gen = torch.Generator().manual_seed(5)
    params = {}
    for k, v in M1((8, 32, 32), 3, 2, device="cpu", **kw).params.items():
        if k.endswith("kernel"):
            fan_in = v[..., 0].numel()
            params[k] = torch.randn(v.shape, generator=gen) / fan_in ** 0.5
        elif k.endswith("scale"):
            params[k] = 1 + 0.3 * torch.randn(v.shape, generator=gen)
        else:
            params[k] = 0.3 * torch.randn(v.shape, generator=gen)
    x = torch.randn(2, 8, 32, 32, 3, generator=torch.Generator().manual_seed(3))

    def grads(device, dt):
        m = M1((8, 32, 32), 3, 2, device=device, init_params=False, dtype=dt, **kw)
        pdt = torch.float64 if dt == torch.float64 else torch.float32
        m.params = {k: v.to(device=device, dtype=pdt) for k, v in params.items()}
        out = m.net(x.to(device=device, dtype=pdt), train=False)["y_softmax"]
        (out[..., 1].to(pdt) ** 2).sum().backward()
        return {k: p.grad.to(pdt).cpu() for k, p in m.net.named_parameters()}

    def rel(got, want):
        return float((got.double() - want).abs().max()) / max(1.0, float(want.abs().max()))

    cpu_sides = BranchReplay()
    with cpu_sides.record():
        cpu32 = grads("cpu", torch.float32)
    keep = [k for k, v in cpu32.items() if v.abs().max() >= 1e-2]
    if dtype == torch.float32:
        card_sides = BranchReplay(values=True)
        with card_sides.record():  # the card's side at every kink
            card = grads(cuda_device, dtype)
        flips = card_sides.flipped(cpu_sides)
        assert len(flips) <= 8 and all(r <= 1e-5 for _, r in flips), flips
        with card_sides.replay():
            exact = grads("cpu", torch.float64)
        err = {k: rel(card[k], exact[k]) for k in keep}
        worst = max(err, key=err.get)
        assert err[worst] <= 1e-3, (worst, err[worst])
        with cpu_sides.replay():
            exact_cpu = grads("cpu", torch.float64)
        unreached = [k for k in keep if rel(exact_cpu[k], exact[k]) <= 1e-4]
        err32 = {k: rel(card[k], cpu32[k].double()) for k in unreached}
        assert all(e <= 1e-3 for e in err32.values()), err32
    else:
        card16, card32 = grads(cuda_device, dtype), grads(cuda_device, torch.float32)
        assert all(bool(torch.isfinite(v).all()) for v in card16.values())
        a = torch.cat([card16[k].reshape(-1) for k in keep])
        b = torch.cat([card32[k].reshape(-1) for k in keep])
        assert float((a - b).norm() / b.norm()) <= 0.2
