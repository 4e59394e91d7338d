"""Data pipeline: manifests, generators, host and device preprocessing, and
the offline ingest (``ingest``: raw cases -> feed + fold manifests)."""

from .generators import (  # noqa: F401
    batch_iterator,
    contour_smoothening,
    custom_data_generator,
    load_image,
    load_sample,
)
from .ingest import ingest_case  # noqa: F401
from .manifest import read_manifest, read_xlsx  # noqa: F401
from .preprocess import (  # noqa: F401
    center_crop,
    resample_img,
    resample_volume,
    resize_image_with_crop_or_pad,
    whitening,
    whitening_device,
)
