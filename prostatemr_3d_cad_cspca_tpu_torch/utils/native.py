"""ctypes loader for the repo's native host kernels (``native/edt.cpp``: the
signed EDT and the per-slice contour smoothening), the port's copy of the
JAX package's ``utils/native.py``.

At first use ``g++ -O3`` builds the source into ``build/native/`` beside the
package (git-ignored), never into ``native/``. Where ``g++`` is missing or
the build fails, every entry point returns None and its caller takes the
scipy or numpy path (``ops.edt``, ``data.generators``), as in the JAX
package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "edt.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")


def _build() -> Optional[str]:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libpmrnative_{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, out)
        return out
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at first use; None without a toolchain."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        path = _build() if os.path.exists(_SRC) else None
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.edt_sq_3d.argtypes = [u8p, f64p] + [ctypes.c_int] * 3
        lib.signed_distance_3d.argtypes = [u8p, f32p] + [ctypes.c_int] * 3
        lib.contour_smooth_u8.argtypes = [u8p, u8p] + [ctypes.c_int] * 4
        for fn in (lib.edt_sq_3d, lib.signed_distance_3d, lib.contour_smooth_u8):
            fn.restype = None
        _LIB = lib
        return _LIB


def signed_distance_3d(pos: np.ndarray) -> Optional[np.ndarray]:
    """Native signed EDT of a (D,H,W) boolean foreground mask, or None."""
    lib = get_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos.astype(np.uint8))
    out = np.empty(pos.shape, np.float32)
    lib.signed_distance_3d(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        *map(int, pos.shape))
    return out


def contour_smooth(label: np.ndarray, ksize: int = 7) -> Optional[np.ndarray]:
    """Native per-slice Gaussian contour smoothening of a (D,H,W) uint8 mask,
    or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(label.astype(np.uint8))
    out = np.empty(src.shape, np.uint8)
    lib.contour_smooth_u8(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        *map(int, src.shape), int(ksize))
    return out
