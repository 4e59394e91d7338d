"""Model: device ms of the active dropouts a window forward of the traced
window (the driver's unit): the kernels inside the program's
``m1.dropout`` spans (models/blocks.py, draws and wheres)."""

from bench_port.harness.spans import ms_per_unit

NAMES = ("m1.dropout",)


def read(v):
    return ms_per_unit(v, NAMES)
