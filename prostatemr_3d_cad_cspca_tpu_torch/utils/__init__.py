"""Host utilities: npz serialization, the native host kernels' loader,
tracing and metrics (``profiling``), the CLI's config overview, FLOP
counting (``flops``) and the Keras H5 importer (``tf_import``)."""

from .overview import print_overview  # noqa: F401
from .profiling import MetricsLogger, StepTimer, annotate, trace  # noqa: F401
