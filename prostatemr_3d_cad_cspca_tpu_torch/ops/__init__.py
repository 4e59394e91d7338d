"""Ops of the M1 path: convolutions (K1, K2), instance norm (K3, K4),
resampling. Each kernel's wrapper runs its plain PyTorch twin on CPU tensors
and its CUDA kernel on CUDA tensors."""
