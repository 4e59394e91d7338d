"""Kernels K1 + K2: the least time of the
window's K1 and K2 calls (counts/m1.py) over the device time of the
kernels that run them, in %."""

from bench_port.harness.readers import roofline

KERNELS = ("conv3d_wgmma_kernel", "wgmma_splitk_reduce_kernel")
KINDS = ("K1", "K2")


def read(v):
    return roofline(v, KERNELS, KINDS)
