"""Kernels K3 + K4: the least time of the window's instance-norm
statistics and apply calls (counts/m1.py) over the device time of their
kernels, in %."""

from bench_port.harness.readers import roofline

KERNELS = ("in_stats_kernel", "in_apply_kernel")
KINDS = ("K3", "K4")


def read(v):
    return roofline(v, KERNELS, KINDS)
