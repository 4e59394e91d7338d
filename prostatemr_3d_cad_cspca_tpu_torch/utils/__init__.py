"""Host utilities: npz serialization, the native host kernels' loader,
tracing and metrics (``profiling``) and the CLI's config overview."""

from .overview import print_overview  # noqa: F401
from .profiling import MetricsLogger, StepTimer, annotate, trace  # noqa: F401
