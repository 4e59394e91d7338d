"""K1-K5 against their plain PyTorch twins on a CUDA card.

The kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a card. This file imports no JAX, so it also runs on a
machine that has only PyTorch; there, skip the JAX-pinning conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

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
