"""Random bits of the port: explicit ``torch.Generator``s in the roles of the
JAX package's PRNG keys.

A JAX key is a value and a ``torch.Generator`` is a stream that advances as
it is drawn from. The port treats a generator's seed as its key:
:func:`fold_in` returns a new generator on the parent's device whose seed is
a fixed function of the parent's seed and an integer, so the same parent and
index give the same bits whatever was drawn from the parent before. The bits
differ from JAX's for the same seed; the tests hand both packages the same
keep-masks instead (see ``models.blocks.dropout``).

``rng`` arguments of the port take a generator, an int seed, None, or a
mapping from dropout site to keep-mask (a replay of given masks, which draws
nothing).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


def fresh(device) -> torch.Generator:
    """A generator with a seed drawn from numpy's global state, as the JAX
    package self-keys with ``np.random.randint(0, 2**31 - 1)``."""
    return generator(np.random.randint(0, 2 ** 31 - 1), device)


def is_mask_map(rng: Any) -> bool:
    return isinstance(rng, Mapping)


def as_rng(rng: Any, device):
    """Normalize an ``rng`` argument: None and mask mappings pass through, an
    int becomes a generator on ``device``, a generator must live there."""
    if rng is None or is_mask_map(rng):
        return rng
    if isinstance(rng, (int, np.integer)):
        return generator(int(rng), device)
    if isinstance(rng, torch.Generator):
        if rng.device.type != torch.device(device).type:
            raise ValueError(f"rng is a generator on {rng.device}, the tensors "
                             f"live on {device}")
        return rng
    raise TypeError(f"rng must be None, an int, a torch.Generator or a mapping "
                    f"of keep-masks, got {type(rng).__name__}")


def fold_in(rng: torch.Generator, data: int) -> torch.Generator:
    """A child generator (JAX's ``fold_in``): its seed is a fixed function of
    ``rng``'s seed and ``data``."""
    if is_mask_map(rng):
        raise TypeError("a mapping of keep-masks replays one forward; it cannot "
                        "be folded into per-view, per-member or per-chunk streams")
    state = np.random.SeedSequence([int(rng.initial_seed()), int(data)]
                                   ).generate_state(2, np.uint32)
    seed = (int(state[0]) << 31) ^ int(state[1])
    return torch.Generator(device=rng.device).manual_seed(seed)
