"""Single-file model serialization: architecture config + parameters.

Same format as the JAX package's ``utils/serialization.py``, so checkpoints
move both ways: one ``.npz`` holding every parameter under its '/'-joined
flax keypath (``core/serse1/conv1/kernel`` ...) plus a ``__config__`` JSON
blob. Atomic write (tmp + rename).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Tuple

import numpy as np


def _to_numpy(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):  # a torch tensor
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def flatten(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict (or an already '/'-flat dict) -> '/'-keyed numpy leaves."""
    flat: Dict[str, np.ndarray] = {}
    for key in sorted(params):
        val = params[key]
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            flat.update(flatten(val, path))
        else:
            flat[path] = _to_numpy(val)
    return flat


def unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def save_model(path: str, config: Dict[str, Any], params) -> None:
    flat = flatten(params)
    flat["__config__"] = np.frombuffer(
        json.dumps(config, default=str).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_model(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    config = json.loads(bytes(flat.pop("__config__").tobytes()).decode())
    # JSON turns tuples into lists; the model ctor normalizes them
    return config, unflatten(flat)
