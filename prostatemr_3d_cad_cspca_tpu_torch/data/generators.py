"""The test-mode image read of the JAX package's
``data/generators.py::load_sample`` (``:99-124``): what serving needs. Labels,
contour smoothening and the training generators wait for the data slice."""

from __future__ import annotations

from typing import Dict

import numpy as np


def load_image(row: Dict[str, str], train_obj: str = "zonal") -> np.ndarray:
    """One case's (D, H, W, C) fp32 image as ``load_sample(mode='test')``
    yields it (the zonal task keeps the first channel only)."""
    if train_obj == "zonal":
        image = np.load(row["image_path"])[:, :, :, :1]
    elif train_obj == "lesion":
        image = np.load(row["image_path"])
    else:
        raise ValueError(f"Unknown train_obj {train_obj!r}")
    return image.astype(np.float32)
