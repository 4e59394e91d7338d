"""prostatemr_3d_cad_cspca_tpu_torch — the PyTorch/CUDA port of
``prostatemr_3d_cad_cspca_tpu`` for an NVIDIA H100 (Hopper, sm_90a).

It stands alone: it imports torch and numpy, never jax, flax or the JAX
package. Its modules mirror the JAX package's names, its public layout is
NDHWC and its checkpoints are the JAX package's npz files. Entry points run
on the card unless the caller passes ``device="cpu"``; on the CPU each kernel
wrapper runs its plain PyTorch twin.

It serves every M1 detector the JAX package builds:
  - models.M1 / m1 / M1Core / M1Net / M1CascadedNet — model surface and
    backbone: Monte-Carlo dropout, dense skips and deep supervision, the
    hierarchical probabilistic ladder, the two-stage cascade
  - infer — mc_predict, sliding-window inference, chunked batches
  - ensemble — fold ensembles (M1Ensemble) and flip TTA (tta_detect)
  - serve.InferenceSession / serve.run — batched serving, MC mean and std,
    whole-gland cases by sliding window; serve.ExportedSession from an
    artifact
  - export — export_model / ExportedModel / validate_artifact: the detect
    program frozen with torch.export into one artifact (K1-K4 as the
    registered pmr:: operators)
  - load.load_model_spec — one checkpoint, a comma-separated ensemble or an
    exported artifact
  - bridge — parameters to and from the JAX package's flax tree
  - prng — torch.Generators in the roles of JAX's PRNG keys, and random
    draws given as tensors (an artifact's inputs)
  - ops — K1 conv3d, K2 conv3d_transpose, K3 in_stats, K4 in_apply,
    K5 gemm_loop (hand-written CUDA in csrc/, built at first use)
  - probes.gemm_rate — the GEMM-rate probe entry point (K5, K1)
  - utils.flops — conv and matmul FLOPs of a call, from its exported graph
  - utils.tf_import — the reference's Keras H5 checkpoints into the port
"""

__version__ = "0.2.0"

from .models import M1, M1Core, M1Net, m1  # noqa: F401
