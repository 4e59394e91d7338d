"""Model: device ms of the attention gates a window forward of the traced
window (the driver's unit): the kernels inside the program's ``m1.gate``
spans (models/blocks.py, K1, K3 and K4 of the gates included)."""

from bench_port.harness.spans import ms_per_unit

NAMES = ("m1.gate",)


def read(v):
    return ms_per_unit(v, NAMES)
