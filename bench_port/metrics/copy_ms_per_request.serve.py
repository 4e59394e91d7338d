"""Serving: device ms of host-device copies (the request's upload, the
result's readback) a request of the traced window."""

def read(v):
    units = v.work.get("units", 0)
    copies = [op for op in v.device_ops() if op[0].startswith("Memcpy")]
    if not units or not copies:
        return None
    return sum(e - s for _, s, e in copies) / 1e3 / units
