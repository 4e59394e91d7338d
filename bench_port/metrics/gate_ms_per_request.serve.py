"""Model: device ms of the attention gates a request of the traced window:
the kernels inside the program's ``m1.gate`` spans (models/blocks.py, the
whole gate, its K1, K3 and K4 included)."""

from bench_port.harness.spans import ms_per_unit

NAMES = ("m1.gate",)


def read(v):
    return ms_per_unit(v, NAMES)
