"""Build the package's CUDA kernels at first use.

Each ``csrc/<name>.cu`` is compiled by nvcc for Hopper (``sm_90a``) into
``_build/lib<name>.so``: a shared library with a plain C interface that the
op modules load with ctypes.  No PyTorch header is included, so a build
takes seconds.  A library is rebuilt when its source is newer; the build
writes to a temporary name and renames it, so concurrent builds never load
a half-written file.  ``--use_fast_math`` is deliberately absent: the
normalisations divide, and must divide as IEEE does to match their plain
PyTorch versions.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is up to date.  Returns
    the compiler's output (register and shared-memory use per kernel), or
    "" when nothing was built."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    out = lib_path(name)
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = _libs[name] = ctypes.CDLL(lib_path(name))
        return lib
