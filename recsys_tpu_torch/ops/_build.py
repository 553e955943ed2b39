"""Build and load the port's CUDA kernels (nvcc -> .so -> ctypes).

``csrc/*.cu`` compile at first use into ``build/recsys_tpu_torch/`` at
the repository root, as one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds).  The library's name
carries a hash of the sources and flags, so an edited source rebuilds
and an unchanged one is reused.  A failed build raises: nothing falls
back to the plain torch path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "recsys_tpu_torch")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *ARCH_FLAGS]

_lock = threading.Lock()
_lib = None
# ptxas's report of the last build (registers, shared memory, spills).
build_log = ""


def sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")
    return found


def _digest(srcs: list[str]) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in srcs:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels if no library for these sources exists; returns its path."""
    global build_log
    srcs = sources()
    so = os.path.join(BUILD_DIR, f"librecsys_tpu_torch_{_digest(srcs)}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *FLAGS, "-o", tmp, *srcs]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    build_log = r.stdout + r.stderr
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{build_log}")
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The built kernel library with every entry point's signature declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.rs_resident_train_top1
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int,          # At, a_kind
                *([ctypes.c_void_p] * 11),              # Lt_in .. top1
                *([ctypes.c_int] * 5),                  # K, U, I, G, iters
                ctypes.c_float,                         # alpha2
                ctypes.c_int, ctypes.c_int,             # precision, items_true
                *([ctypes.c_int] * 4),                  # chunk_l, s_l, chunk_r, s_r
                ctypes.c_void_p,                        # stream
            ]
            _lib = lib
    return _lib
