"""prostatemr_3d_cad_cspca_tpu_torch — the PyTorch/CUDA port of
``prostatemr_3d_cad_cspca_tpu`` for an NVIDIA H100 (Hopper, sm_90a).

It stands alone: it imports torch and numpy, never jax, flax or the JAX
package. Its modules mirror the JAX package's names, its public layout is
NDHWC and its checkpoints are the JAX package's npz files. Entry points run
on the card unless the caller passes ``device="cpu"``; on the CPU each kernel
wrapper runs its plain PyTorch twin.

It serves the M1 detector the training CLI builds by default:
  - models.M1 / m1 / M1Core / M1Net — model surface and backbone, with
    Monte-Carlo dropout
  - infer — mc_predict, sliding-window inference, chunked batches
  - ensemble — fold ensembles (M1Ensemble) and flip TTA (tta_detect)
  - serve.InferenceSession / serve.run — batched serving, MC mean and std,
    whole-gland cases by sliding window
  - load.load_model_spec — one checkpoint or a comma-separated ensemble
  - bridge — parameters to and from the JAX package's flax tree
  - prng — torch.Generators in the roles of JAX's PRNG keys
  - ops — K1 conv3d, K2 conv3d_transpose, K3 in_stats, K4 in_apply,
    K5 gemm_loop (hand-written CUDA in csrc/, built at first use)
  - probes.gemm_rate — the GEMM-rate probe entry point (K5, K1)
"""

__version__ = "0.2.0"

from .models import M1, M1Core, M1Net, m1  # noqa: F401
