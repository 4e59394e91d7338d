"""``serve.py``'s requests to ``serve.InferenceSession`` for M1 with nested
dense skips: the same traffic, session, faults and comparison, with the
weights' shapes, the counted calls and the plain reference of
``reference/m1_dense.py`` and ``counts/m1_dense.py``.

The base driver draws its weights from ``reference.m1.param_shapes`` and
checks against ``reference.m1.mc_mean_std``, both of which refuse dense
skips; ``setup`` and ``check`` here run the base's with the dense
reference's in their place.
"""

from __future__ import annotations

import contextlib

from bench_port.counts.m1_dense import detect_calls
from bench_port.drivers import serve
from bench_port.harness import seeds, weights
from bench_port.reference import m1_dense

VARIANTS = serve.VARIANTS  # the base's control and faults


def make_weights(cfg: dict, model: dict, seed: int, device):
    """``harness.session.make_weights``, over the dense reference's shapes."""
    return weights.make(m1_dense.param_shapes(model), cfg["weights"],
                        seeds.child(seed, "weights"), device)


@contextlib.contextmanager
def _dense(name, fn):
    """``serve.<name>`` is ``fn`` for the body."""
    real = getattr(serve, name)
    setattr(serve, name, fn)
    try:
        yield
    finally:
        setattr(serve, name, real)


class Cell(serve.Cell):
    def setup(self):
        with _dense("make_weights", make_weights):
            super().setup()

    def work(self, w):
        return {"units": len(w["latencies"]),
                "calls": detect_calls(self.model_cfg, self.batch * self.mc, self.wl["dtype"])}

    def check(self, w):
        with _dense("mc_mean_std", m1_dense.mc_mean_std):
            return super().check(w)
