"""Model: device ms of the dense skips' up-chains a request of the traced
window: the kernels inside the program's ``m1.dense`` spans
(models/m1_core.py, each of the six up-chain transposed convs)."""

from bench_port.harness.spans import ms_per_unit

NAMES = ("m1.dense",)


def read(v):
    return ms_per_unit(v, NAMES)
