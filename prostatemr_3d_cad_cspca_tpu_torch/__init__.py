"""prostatemr_3d_cad_cspca_tpu_torch — the PyTorch/CUDA port of
``prostatemr_3d_cad_cspca_tpu`` for an NVIDIA H100 (Hopper, sm_90a).

It stands alone: it imports torch and numpy, never jax, flax or the JAX
package. Its modules mirror the JAX package's names, its public layout is
NDHWC and its checkpoints are the JAX package's npz files. Entry points run
on the card unless the caller passes ``device="cpu"``; on the CPU each kernel
wrapper runs its plain PyTorch twin.

This slice serves the deterministic M1 detector:
  - models.M1 / m1 / M1Core / M1Net — model surface and backbone
  - serve.InferenceSession / serve.run — batched window-sized serving
  - load.load_model_spec — single-checkpoint loading
  - bridge — parameters to and from the JAX package's flax tree
  - ops — K1 conv3d, K2 conv3d_transpose, K3 in_stats, K4 in_apply
    (hand-written CUDA in csrc/, built at first use)
"""

__version__ = "0.1.0"

from .models import M1, M1Core, M1Net, m1  # noqa: F401
