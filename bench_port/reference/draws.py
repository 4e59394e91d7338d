"""The rules by which the program draws its random bits, frozen here so the
reference can draw the same bits from the same seeds (the port's ``prng``
module states them): a generator is a ``torch.Generator`` seeded with an
int on the device; ``fold_in(seed, data)`` is a fixed function of the two
ints; a uniform is ``torch.rand`` in fp32 and a normal ``torch.randn`` in
fp32, each of the activation's (N, D, H, W, C) shape, drawn in the order the
forward reaches them."""

from __future__ import annotations

import numpy as np
import torch

AUGMENT_FOLD = 1 << 20  # the augmentation's child of a train step's generator


def fold_in(seed: int, data: int) -> int:
    """The child seed of ``seed`` for ``data``."""
    state = np.random.SeedSequence([int(seed), int(data)]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def fold_path(seed: int, *path: int) -> int:
    for data in path:
        seed = fold_in(seed, data)
    return seed


class Stream:
    """One generator's draws, in order."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))

    def uniform(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.gen, dtype=torch.float32,
                          device=self.device)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.gen, dtype=torch.float32,
                           device=self.device)

