"""M1Net, port of the JAX package's ``models/m1_net.py`` for its
single-stage branch (``m1_net.py:131-135``). The probabilistic branch, the
cascade and decision fusion wait for their slices."""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from .m1_core import M1Core


class M1Net(nn.Module):
    """Single-stage M1: ``forward(image, train, rng)`` returns y_softmax /
    y_sigmoid / logits / y_ (reference ``m1()``); ``rng`` feeds the dropout
    sites (see ``M1Core``)."""

    def __init__(self, input_channels: int, probabilistic: bool = False,
                 **core_kwargs):
        super().__init__()
        if probabilistic:
            raise NotImplementedError(
                "probabilistic M1 waits for the probabilistic slice")
        self.core = M1Core(input_channels, **core_kwargs)

    def forward(self, inputs: torch.Tensor, train: bool = False,
                rng=None) -> Dict[str, Any]:
        out = self.core(inputs, train=train, rng=rng)
        return dict(y_softmax=out["y_softmax"], y_sigmoid=out["y_sigmoid"],
                    logits=out["logits"], y_=out["y_"])
