"""Serving: device ms of the Monte-Carlo stack and reduction a request of
the traced window: the kernels inside the program's ``infer.mc_stack`` and
``infer.mc_reduce`` spans (infer.py, around the model call)."""

from bench_port.harness.spans import ms_per_unit

NAMES = ("infer.mc_stack", "infer.mc_reduce")


def read(v):
    return ms_per_unit(v, NAMES)
