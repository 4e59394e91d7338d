"""Host-side metrics (lesion candidates for serving); training waits for
the training slice."""
