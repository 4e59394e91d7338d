"""Cross-validation fold ensembles and flip test-time augmentation, port of
the JAX package's ``ensemble.py``.

  * ``M1Ensemble`` runs K fold members of one architecture in turn and
    reduces them on the device as it goes (the JAX scan's carry,
    ``ensemble.py:191-228``): 'mean' and 'mean_std' keep a running mean (and
    sum of squared deviations, Welford) in fp32, so K outputs are never held
    at once. It duck-types the ``M1`` surface ``serve.InferenceSession``
    uses, so ``--MODEL f1.npz,f2.npz,...`` serves the ensemble.
  * ``tta_detect`` averages the 2**n flips of a detect head on the device.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from . import prng
from .device import resolve_device
from .infer import tree_map

# W is axis -2 of (..., D, H, W, C): the axial left-right axis, the one
# label-symmetric flip of this anatomy (the reference's train-time h-flip).
AXIAL_LR_AXIS = -2


def tta_detect(detect_fn: Callable, flip_axes: Sequence[int] = (AXIAL_LR_AXIS,)
               ) -> Callable:
    """Wrap ``detect(params, inputs, rng=None)`` with flip test-time
    augmentation: every subset of ``flip_axes`` (2**n views, identity
    included) flips the input, predicts and flips the prediction back; the
    views are averaged on the device. Axes count from the right of
    ``(..., D, H, W, C)``. With an ``rng``, view i draws from
    ``fold_in(rng, i)``."""
    flip_axes = tuple(int(a) for a in flip_axes)
    for a in flip_axes:
        if a >= -1:
            raise ValueError("flip_axes index spatial dims from the right of "
                             f"(..., D, H, W, C); got {a} (channel/batch axis)")

    def _flip(tree, axes):
        if not axes:
            return tree
        return tree_map(lambda x: torch.flip(x, dims=[x.dim() + a for a in axes]), tree)

    views = [()]
    for a in flip_axes:
        views += [v + (a,) for v in views]

    def detect(params, inputs, rng=None):
        inputs = tree_map(lambda x: x if torch.is_tensor(x)
                          else torch.as_tensor(x, dtype=torch.float32), inputs)
        outs = None
        for i, axes in enumerate(views):
            kw = {} if rng is None else {"rng": prng.fold_in(rng, i)}
            out = _flip(detect_fn(params, _flip(inputs, axes), **kw), axes)
            outs = out if outs is None else tree_map(torch.add, outs, out)
        return tree_map(lambda s: s / len(views), outs)

    return detect


class M1Ensemble:
    """K fold members of one architecture behind one detect head.

    ``get_detect_model()`` returns ``detect(params, inputs, rng=None)``:
    ``params`` None runs the members' own weights, a list of K state dicts
    runs those; with an ``rng`` member i draws from ``fold_in(rng, i)``.
    ``reduce``: 'mean' (member-mean probabilities), 'mean_std' ((mean,
    population std) over members) or None (the stacked (K, ...) outputs).
    """

    def __init__(self, models: Sequence, reduce: Optional[str] = "mean"):
        if not models:
            raise ValueError("an ensemble needs at least one member")
        if reduce not in ("mean", "mean_std", None):
            raise ValueError(f"reduce must be 'mean', 'mean_std' or None, got {reduce!r}")
        base = models[0]
        arch_keys = [k for k in base.config if k not in ("seed", "summary", "init_params")]
        for m in models[1:]:
            diff = [k for k in arch_keys if m.config.get(k) != base.config.get(k)]
            if diff:
                raise ValueError(f"ensemble members disagree on architecture config: {diff}")
        self.members = list(models)
        self.num_members = len(self.members)
        self.reduce = reduce
        self.config = dict(base.config)
        self.cascaded = base.cascaded
        self.probabilistic = base.probabilistic
        self.num_classes = base.num_classes
        self.input_spatial_dims = tuple(base.input_spatial_dims)
        self.input_channels = base.input_channels
        self.device = base.device

    @property
    def stochastic(self) -> bool:
        return self.members[0].stochastic

    @classmethod
    def load(cls, paths: Sequence[str], reduce: Optional[str] = "mean", **overrides):
        """Load fold checkpoints (``M1.save`` / the training CLI's output);
        ``overrides`` go to every ``M1.load`` (``device=``, ``dtype=``)."""
        from .models.m1 import M1

        return cls([M1.load(p, **overrides) for p in paths], reduce=reduce)

    def to(self, device) -> "M1Ensemble":
        self.device = resolve_device(device)
        for m in self.members:
            m.to(self.device)
        return self

    def get_detect_model(self) -> Callable:
        member_detects = [m.get_detect_model() for m in self.members]
        k, reduce = self.num_members, self.reduce

        def detect(params, inputs, rng=None):
            plist = [None] * k if params is None else list(params)
            if len(plist) != k:
                raise ValueError(f"{len(plist)} parameter sets for {k} members")

            def call(i):
                kw = {} if rng is None else {"rng": prng.fold_in(rng, i)}
                return member_detects[i](plist[i], inputs, **kw)

            if reduce is None:
                return tree_map(lambda *ts: torch.stack(ts), *[call(i) for i in range(k)])
            mean = m2 = None
            for i in range(k):
                out = call(i)
                dtype = out.dtype
                out = out.float()
                if mean is None:
                    mean, m2 = out, torch.zeros_like(out)
                    continue
                delta = out - mean
                mean = mean + delta / (i + 1)
                m2 = m2 + delta * (out - mean)
            if reduce == "mean":
                return mean.to(dtype)
            return mean.to(dtype), torch.sqrt(m2 / k).to(dtype)

        return detect

    def predict(self, inputs, rng=None):
        if rng is None and self.stochastic:  # self-key, as M1.predict
            rng = prng.fresh(self.device)
        rng = prng.as_rng(rng, self.device)
        return self.get_detect_model()(None, inputs, rng=rng)
