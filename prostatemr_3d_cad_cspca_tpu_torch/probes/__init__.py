"""Rate probes of the port's kernels (entry points of their own, no model)."""
