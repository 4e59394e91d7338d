"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

At first use one ``nvcc`` call compiles every source under ``csrc/`` for
``sm_90a`` into one shared library with a plain C interface, which ``ctypes``
loads. The library goes to ``build/kernels/`` beside the package, named by a
hash of the sources and flags, so an edited source rebuilds and an unchanged
one is reused. Nothing here runs at import time: the CPU path never needs a
compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("conv3d.cu", "conv3d_mma.cu", "instance_norm.cu", "gemm_loop.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of csrc/common.cuh (pmr::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's stderr of the last build (ptxas register/spill report)

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "pmr_conv3d": [_VP, _VP, _VP, _VP],
    "pmr_conv3d_transpose": [_VP, _VP, _VP, _VP],
    "pmr_conv3d_mma": [_VP, _VP, _VP, _VP],
    "pmr_in_stats": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _VP],
    "pmr_in_apply": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _F, _I, _VP],
    "pmr_gemm_loop": [_VP, _VP, _VP, _VP, _VP, _VP],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC_DIR, name), "rb") as f:
                h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels if no library for these sources exists; return
    the library's path."""
    global build_log
    out = os.path.join(BUILD_DIR, f"libpmr_kernels_{_digest()}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC_DIR, s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{proc.stderr[-8000:]}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _lib = lib
    return _lib


def use_kernel(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU or meta
    tensor (run the plain twin); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def check(rc: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error (its cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t: torch.Tensor, name: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or bfloat16, "
                        f"got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def require_no_grad(name: str, *tensors) -> None:
    """The kernels have no backward yet: refuse to run where autograd would
    silently drop the graph."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward yet (training slice); "
            "run under torch.no_grad()")
