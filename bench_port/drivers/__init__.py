"""One traffic kind a file: ``Cell(cfg, workload, seed, device, variant)``
with ``setup``, ``window``, ``end_to_end``, ``work``, ``release`` and
``check``."""
