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


# fp32: kernel (fp32 FMA) vs cuDNN fp32 differ by summation order only;
# bf16: both round one fp32 result, so at most one bf16 step apart.
CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


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


# Where the bf16 tensor-core kernel differs from the FMA one: narrow cout
# (scalar weight loads, n8 tiles), a misaligned part (scalar gather), split-K.
# Split-K does not loosen the bf16 tolerance: the partials stay fp32 and the
# reduce rounds their fixed-order sum once, so the kernel and its twin still
# each round one fp32 sum of the same products to bf16.
@pytest.mark.cuda
@pytest.mark.parametrize("cout", [1, 2, 4, 8])
def test_card_conv3d_narrow_cout(cuda_device, cout):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(2, 5, 9, 10, 16, generator=g, device=cuda_device).to(torch.bfloat16)
    kernel = (torch.randn(3, 3, 3, 16, cout, generator=g, device=cuda_device) / 8
              ).to(torch.bfloat16)
    bias = torch.randn(cout, generator=g, device=cuda_device)
    assert tconv.gather_routes([x], kernel)[1] == (
        "cp.async" if cout == 8 else "scalar")
    got = tconv.conv3d([x], kernel, bias)
    ref = tconv.conv3d_plain([x], kernel, bias)
    torch.cuda.synchronize()
    assert _card_err(got, ref) <= CARD_TOL[torch.bfloat16]


@pytest.mark.cuda
def test_card_conv3d_misaligned_part_takes_the_scalar_gather(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(4)
    shape = (2, 5, 9, 10, 16)
    flat = torch.randn(math.prod(shape) + 1, generator=g, device=cuda_device)
    shifted = flat.to(torch.bfloat16)[1:].view(shape)  # contiguous, 2 bytes off
    aligned = torch.randn(shape, generator=g, device=cuda_device).to(torch.bfloat16)
    kernel = (torch.randn(3, 3, 3, 32, 24, generator=g, device=cuda_device) / 8
              ).to(torch.bfloat16)
    bias = torch.randn(24, generator=g, device=cuda_device)
    parts = [aligned, shifted]
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    assert tconv.gather_routes(parts, kernel) == (["cp.async", "scalar"], "cp.async")
    got = tconv.conv3d(parts, kernel, bias, (1, 2, 2))
    ref = tconv.conv3d_plain(parts, kernel, bias, (1, 2, 2))
    torch.cuda.synchronize()
    assert _card_err(got, ref) <= CARD_TOL[torch.bfloat16]


SPLIT_CASES = [  # (part shapes, kernel, strides, transposed): split-K at batch 2
    ([(2, 5, 10, 10, 256)], (3, 3, 3, 256, 128), (1, 1, 1), False),
    ([(2, 10, 20, 20, 128)] * 2, (3, 3, 3, 256, 128), (1, 1, 1), False),
    ([(2, 5, 10, 10, 256)], (3, 3, 3, 128, 256), (2, 2, 2), True),
]


def _split_case(device, shapes, kshape, transposed, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    parts = [torch.randn(s, generator=g, device=device).to(torch.bfloat16) for s in shapes]
    fan_in = math.prod(kshape[:3]) * kshape[4 if transposed else 3]
    kernel = (torch.randn(kshape, generator=g, device=device) / fan_in ** 0.5
              ).to(torch.bfloat16)
    bias = torch.randn(kshape[3 if transposed else 4], generator=g, device=device)
    return parts, kernel, bias


def _split_run(parts, kernel, bias, st, transposed):
    if transposed:
        return (tconv.conv3d_transpose(parts[0], kernel, bias, st),
                tconv.conv3d_transpose_plain(parts[0], kernel, bias, st))
    return tconv.conv3d(parts, kernel, bias, st), tconv.conv3d_plain(parts, kernel, bias, st)


def _splits(parts, kernel, st, transposed):
    return tconv.igemm_schedule([p.shape for p in parts], kernel.shape, st,
                                transposed)[1]["splits"]


@pytest.mark.cuda
@pytest.mark.parametrize("shapes,kshape,st,transposed", SPLIT_CASES)
def test_card_split_k_matches_plain(cuda_device, shapes, kshape, st, transposed):
    parts, kernel, bias = _split_case(cuda_device, shapes, kshape, transposed, 5)
    assert _splits(parts, kernel, st, transposed) > 1
    got, ref = _split_run(parts, kernel, bias, st, transposed)
    torch.cuda.synchronize()
    assert _card_err(got, ref) <= CARD_TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("shapes,kshape,st,transposed", SPLIT_CASES)
def test_card_split_k_is_bit_reproducible(cuda_device, shapes, kshape, st, transposed):
    parts, kernel, bias = _split_case(cuda_device, shapes, kshape, transposed, 6)
    first = _split_run(parts, kernel, bias, st, transposed)[0]
    second = _split_run(parts, kernel, bias, st, transposed)[0]
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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
