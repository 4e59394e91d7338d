"""Seeds of a run. Every stream the benchmark draws from (weights, inputs,
the sample it checks) is a child of ``--seed`` by a tag, so one seed gives
one run's inputs whatever else is drawn."""

from __future__ import annotations

import zlib

import numpy as np


def child(seed: int, *tags) -> int:
    """A 63-bit seed from ``seed`` and ``tags`` (strings or ints)."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32]
    for t in tags:
        words.append(zlib.crc32(t.encode()) if isinstance(t, str) else int(t))
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])
