"""Checkpoint-spec loader of the serve CLI (the JAX package's ``load.py``).

Spec grammar:
  "ckpt.npz"            -> M1.load
  "f1.npz,f2.npz,..."   -> ensemble.M1Ensemble.load (members run in turn)
An exported ``.zip`` artifact raises and names the slice it waits for.
"""

from __future__ import annotations

__all__ = ["load_model_spec"]


def load_model_spec(spec: str, seed: int = 0, allow_artifact: bool = False,
                    device="cuda", **overrides):
    """Resolve a --MODEL argument to a loaded model on ``device``;
    ``overrides`` (e.g. ``dtype=``) go to every ``M1.load``."""
    del seed, allow_artifact  # used by the artifact path only
    paths = [p.strip() for p in str(spec).split(",") if p.strip()]
    if not paths:
        raise ValueError(f"empty --MODEL spec: {spec!r}")
    if any(p.endswith(".zip") for p in paths):
        raise NotImplementedError(
            "exported artifacts (.zip) wait for the export slice")
    if len(paths) > 1:
        from .ensemble import M1Ensemble

        return M1Ensemble.load(paths, device=device, **overrides)
    from .models.m1 import M1

    return M1.load(paths[0], device=device, **overrides)
