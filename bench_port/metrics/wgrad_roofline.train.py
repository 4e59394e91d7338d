"""Kernel K6: the least time of the window's conv weight-gradient calls
(counts/m1.py) over the device time of the kernels that run them (the
main kernel, its split reduce and fp32's split into bf16 planes), in %."""

from bench_port.harness.readers import roofline

KERNELS = ("wgrad_wgmma_kernel", "wgrad_reduce_kernel", "wgrad_split_kernel")
KINDS = ("K6",)


def read(v):
    return roofline(v, KERNELS, KINDS)
