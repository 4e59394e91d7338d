"""Checkpoint-spec loader of the serve CLI (the JAX package's ``load.py``).

This slice loads one ``.npz`` checkpoint. A comma-separated fold ensemble
and an exported ``.zip`` artifact raise and name the slice they wait for.
"""

from __future__ import annotations

__all__ = ["load_model_spec"]


def load_model_spec(spec: str, seed: int = 0, allow_artifact: bool = False,
                    device="cuda"):
    """Resolve a --MODEL argument to a loaded model on ``device``."""
    del seed, allow_artifact  # used by the ensemble / artifact paths only
    paths = [p.strip() for p in str(spec).split(",") if p.strip()]
    if not paths:
        raise ValueError(f"empty --MODEL spec: {spec!r}")
    if len(paths) > 1:
        raise NotImplementedError(
            "fold ensembles (comma-separated checkpoints) wait for the "
            "inference slice (ensemble.py)")
    if paths[0].endswith(".zip"):
        raise NotImplementedError(
            "exported artifacts (.zip) wait for the export slice")
    from .models.m1 import M1

    return M1.load(paths[0], device=device)
