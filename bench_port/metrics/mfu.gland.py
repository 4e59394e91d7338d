"""Model: the window's convolution FLOPs (counts/m1.py, forward; the
sliding window's zero-weight padding tiles left out) over the window times
the card's tensor peak for the cell's dtype (counts/peaks.json), in %."""

from bench_port.harness.readers import mfu


def read(v):
    return mfu(v)
