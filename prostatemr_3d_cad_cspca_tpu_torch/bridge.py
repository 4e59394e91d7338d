"""Parameters between the JAX package's flax tree and the port's modules.

The port stores every weight in the JAX layout (conv kernels DHWIO,
transposed-conv kernels (kd,kh,kw,Cout,Cin), SE kernels (1,1,1,Cin,Cout),
IN ``scale``/``bias``) and names its submodules after the flax tree, so the
mapping is the keypath with '.' for '/' and no permutation.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from .utils.serialization import flatten


def from_jax_params(tree_or_flat) -> Dict[str, torch.Tensor]:
    """flax param tree (nested dict) or '/'-flat dict -> a state dict."""
    return {key.replace("/", "."): torch.from_numpy(np.array(val))
            for key, val in flatten(tree_or_flat).items()}


def to_jax_params(module: nn.Module) -> Dict[str, np.ndarray]:
    """A module's parameters -> flat '/'-keyed numpy dict (the npz keys)."""
    return {name.replace(".", "/"): p.detach().cpu().numpy()
            for name, p in module.named_parameters()}
