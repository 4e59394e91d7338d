"""Model: device ms of the convs over a stitch's part list a request of the
traced window: the kernels inside the program's ``m1.stitch`` spans
(models/blocks.py, the first and the projection conv of a decoder or
ladder SE block)."""

from bench_port.harness.spans import ms_per_unit

NAMES = ("m1.stitch",)


def read(v):
    return ms_per_unit(v, NAMES)
