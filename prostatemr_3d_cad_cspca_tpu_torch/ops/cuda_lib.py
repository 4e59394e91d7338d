"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

At first use one ``nvcc`` a source, all started together, compiles the
sources under ``csrc/`` for ``sm_90a``; one more links them into a shared
library with a plain C interface, which ``ctypes`` loads. The library goes
to ``build/kernels/`` beside the package, named by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one is reused. Nothing
here runs at import time: the CPU path never needs a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("conv3d_wgmma.cu", "conv3d_wgrad.cu", "instance_norm.cu", "gemm_loop.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")
STAMPS_FLAG = "-DPMR_STAMPS"

# dtype codes of csrc/common.cuh (pmr::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's stderr of the library's build (ptxas register/spill report)
build_seconds = {}  # each source's compile and the link, in the last build

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "pmr_conv3d_wgmma": [_VP, _VP, _VP, _VP],
    "pmr_conv3d_wgmma_stamps": [_VP],
    "pmr_in_stats": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _VP],
    "pmr_in_apply": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _F, _I, _I, _I, _I, _VP],
    "pmr_gemm_loop": [_VP, _VP, _VP, _VP, _VP, _VP],
    "pmr_conv3d_wgrad": [_VP, _VP, _VP, _VP, _VP, _I, _VP],
    "pmr_conv3d_wgrad_stamps": [_VP],
    "pmr_in_backward": [_VP] * 9 + [_I] * 4 + [_F] + [_I] * 4 + [_VP],
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


def compile_flags() -> tuple:
    """nvcc's flags for one source: COMPILE_FLAGS, and STAMPS_FLAG where
    ``PMR_STAMPS=1`` asks for the diagnostic build."""
    return COMPILE_FLAGS + ((STAMPS_FLAG,) if os.environ.get("PMR_STAMPS") == "1" else ())


def _digest() -> str:
    h = hashlib.sha256(" ".join(compile_flags() + LINK_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC_DIR, name), "rb") as f:
                h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels if no library for these sources exists; return
    the library's path. Each source compiles in its own ``nvcc`` process,
    all at once; then one links the objects."""
    global build_log, build_seconds
    out = os.path.join(BUILD_DIR, f"libpmr_kernels_{_digest()}.so")
    if os.path.exists(out):
        if os.path.exists(out + ".log"):  # the ptxas report of the build that made it
            with open(out + ".log") as f:
                build_log = f.read()
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{src}.{tag}.o") for src in SOURCES]
    logs = [tempfile.TemporaryFile("w+") for _ in SOURCES]
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([nvcc, *compile_flags(), "-c", "-o", obj,
                                   os.path.join(CSRC_DIR, src)],
                                  stdout=log, stderr=subprocess.STDOUT, text=True)
                 for src, obj, log in zip(SOURCES, objs, logs)]
        seconds = {}
        for src, proc in zip(SOURCES, procs):
            proc.wait()
            seconds[src] = round(time.perf_counter() - t0, 3)
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read())
        build_log = "".join(texts)
        failed = [(src, p.returncode, text) for src, p, text in zip(SOURCES, procs, texts)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{src} (code {rc}):\n{text[-6000:]}" for src, rc, text in failed))
        tmp = f"{out}.{tag}"
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", tmp, *objs], capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed with code {link.returncode}:\n"
                               f"{link.stderr[-6000:]}")
        seconds["link"] = round(time.perf_counter() - t0, 3)
        build_seconds = seconds
        with open(f"{out}.log.{tag}", "w") as f:
            f.write(build_log)
        os.replace(f"{out}.log.{tag}", out + ".log")
        os.replace(tmp, out)
    finally:
        for log in logs:
            log.close()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
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


def register_op(name: str, schema: str, cpu, cuda, fake):
    """``pmr::<name>`` as a ``torch.library`` operator: ``cpu`` (the plain
    twin) and ``cuda`` (the kernel's launch) by the device of its tensors,
    ``fake`` for fake and meta tensors (the output's shape, batch axis kept
    symbolic). No other device has an implementation."""
    op = torch.library.custom_op(f"pmr::{name}", cpu, mutates_args=(), device_types="cpu",
                                 schema=schema)
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)


def use_kernel(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU or meta
    tensor (run the plain twin); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def exporting() -> bool:
    """True while ``torch.export`` traces. The wrappers of K1-K4 then call
    their registered ``pmr::`` operator, one opaque node of the exported
    graph that dispatches by device where the program runs (the CUDA
    implementation launches the kernel, the CPU one runs the twin, the fake
    one gives the output's shape); the live path keeps the direct call."""
    return torch.compiler.is_exporting()


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
    """For a kernel without a backward (K5): refuse to run where autograd
    would silently drop the graph."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward; run under torch.no_grad()")
