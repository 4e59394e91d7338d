"""Serving: device ms of the inference layer's work around the model calls
a window forward of the traced window (the driver's unit): the kernels
inside the program's spans of the sliding window's tile gather, blend and
finish (``sw.*``, infer.py), the flip views (``tta.flip``) and the members'
Welford mean (``ensemble.reduce``, ensemble.py)."""

from bench_port.harness.spans import ms_per_unit

NAMES = ("sw.gather", "sw.blend", "sw.finish", "tta.flip", "ensemble.reduce")


def read(v):
    return ms_per_unit(v, NAMES)
