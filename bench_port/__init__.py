"""The benchmark of the PyTorch and CUDA port (``prostatemr_3d_cad_cspca_tpu_torch``).

``run.py`` runs one cell; see ``README.md``.
"""
