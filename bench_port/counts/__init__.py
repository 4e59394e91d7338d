"""Frozen counts of the work the program's kernels do, from the
configuration's shapes alone: each call's operations and bytes, the
model's FLOPs, and the card's peaks (``peaks.json``)."""
