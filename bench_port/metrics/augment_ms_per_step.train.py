"""Training: device ms of the kernels launched inside the program's
``augment`` range (augment.py) a step of the traced window."""

def read(v):
    steps = v.work.get("units", 0)
    ms = v.range_seconds("augment") * 1e3
    if not steps or ms <= 0:
        return None
    return ms / steps
