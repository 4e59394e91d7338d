"""Host-side data helpers the serving path needs: manifests, the test-mode
image read, whitening."""

from .generators import load_image  # noqa: F401
from .manifest import read_manifest, read_xlsx  # noqa: F401
from .preprocess import whitening  # noqa: F401
