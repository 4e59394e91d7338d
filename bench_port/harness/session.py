"""Building the program's model from the benchmark's weights, and the
pieces every driver shares."""

from __future__ import annotations

import contextlib
import random

import numpy as np
import torch

from ..reference.m1 import param_shapes
from . import seeds, weights


def model_config(cfg: dict, variant=None, control=None) -> dict:
    """The model dict of the cell, with the control's switch where the run
    is the control (``control``: the config keys the control sets)."""
    model = dict(cfg["model"])
    if variant == "control":
        model.update(control or {})
    return model


def make_weights(cfg: dict, model: dict, seed: int, device, tag="weights"):
    return weights.make(param_shapes(model), cfg["weights"], seeds.child(seed, tag), device)


def build_model(model: dict, params, dtype: str, device):
    """The program's M1 at ``dtype`` on ``device``, holding a copy of
    ``params`` (loaded by name, strictly)."""
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1

    m = M1(**model, dtype=getattr(torch, dtype) if dtype != "float32" else None,
           device=device, init_params=False, summary=False)
    m.params = params
    return m


def host_inputs(shape, count: int, seed: int, device, zero_channels=0):
    """``count`` fp32 host arrays of ``shape`` (…, C), standard normal, drawn
    on the device from ``seed`` in one call; the last ``zero_channels``
    channels zero (a probabilistic model's label channel at test time)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    x = torch.randn((count, *shape), generator=gen, dtype=torch.float32, device=device)
    if zero_channels:
        x[..., -zero_channels:] = 0.0
    host = x.cpu().numpy()
    return [np.ascontiguousarray(host[i]) for i in range(count)]


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from ``seed``."""

    def __init__(self, k: int, seed: int):
        self.k, self.rnd, self.n, self.items = int(k), random.Random(seed), 0, []

    def offer(self, make):
        """Offer the stream's next item (``make()`` builds it only if kept)."""
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = self.rnd.randrange(self.n)
            if j < self.k:
                self.items[j] = make()


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


@contextlib.contextmanager
def reference_precision(tf32: bool):
    """fp32 matrix products and convolutions in full fp32 (or in TF32, for
    the control of an fp32 cell)."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def free(device):
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
