"""One checkpoint-spec loader shared by the serve, export and evaluate CLIs
(the JAX package's ``load.py``).

Spec grammar:
  "ckpt.npz"            -> M1.load
  "f1.npz,f2.npz,..."   -> ensemble.M1Ensemble.load (members run in turn)
  "artifact.zip"        -> export.ExportedModel.load (a frozen program),
                           only where the caller can serve from one
                           (allow_artifact=True)
"""

from __future__ import annotations

__all__ = ["load_model_spec"]


def load_model_spec(spec: str, seed: int = 0, allow_artifact: bool = False,
                    device="cuda", **overrides):
    """Resolve a --MODEL argument to a loaded model on ``device``;
    ``overrides`` (e.g. ``dtype=``) go to every ``M1.load``; ``seed`` seeds
    an artifact's draws."""
    paths = [p.strip() for p in str(spec).split(",") if p.strip()]
    if not paths:
        raise ValueError(f"empty --MODEL spec: {spec!r}")
    if any(p.endswith(".zip") for p in paths):
        if len(paths) > 1 or not allow_artifact:
            raise ValueError(
                f"{spec}: exported artifacts are frozen inference programs "
                "(serve-only); this command needs a live checkpoint (.npz) or a "
                "comma-separated fold ensemble")
        from .export import ExportedModel

        return ExportedModel.load(paths[0], seed=seed, device=device)
    if len(paths) > 1:
        from .ensemble import M1Ensemble

        return M1Ensemble.load(paths, device=device, **overrides)
    from .models.m1 import M1

    return M1.load(paths[0], device=device, **overrides)
