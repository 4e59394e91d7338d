"""Model: device ms of the active dropouts a request of the traced window:
the kernels inside the program's ``m1.dropout`` spans (models/blocks.py,
the keep-mask's draw and the where)."""

from bench_port.harness.spans import ms_per_unit

NAMES = ("m1.dropout",)


def read(v):
    return ms_per_unit(v, NAMES)
