"""Model: device ms of the squeeze-excite tails a request of the traced
window: the kernels inside the program's ``m1.se`` spans (models/blocks.py,
from the squeeze's mean to the block's last store)."""

from bench_port.harness.spans import ms_per_unit

NAMES = ("m1.se",)


def read(v):
    return ms_per_unit(v, NAMES)
