"""Device: % of the traced window in which no operation ran on the card
(1 - the union of the device's intervals over the window)."""

from bench_port.harness.readers import idle_share


def read(v):
    return idle_share(v)
