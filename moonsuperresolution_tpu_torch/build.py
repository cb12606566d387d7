"""Build the package's native code at first use.

Each ``csrc/<name>.cu`` is a CUDA kernel, compiled by nvcc for Hopper
(``sm_90a``) into ``_build/lib<name>.so``: a shared library with a plain C
interface that the op modules load with ctypes.  No PyTorch header is
included, so a build takes seconds.  ``--use_fast_math`` is deliberately
absent: the normalisations divide, and must divide as IEEE does to match
their plain PyTorch versions.

Each ``csrc/<name>.cpp`` is host code (the LZW codec of ``geo/lzw.py``),
compiled by g++ the same way (``build_host``).  ``sources()`` lists only the
CUDA kernels.

A library is rebuilt when its source is newer; a build writes to a
temporary name and renames it, so concurrent builds never load a
half-written file.  The compiler's output is kept beside the library
(``_build/lib<name>.log``), so that a library built before reports what
ptxas said of it all the same.  A failed build raises.
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
GXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

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


def gxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        raise RuntimeError("g++ not found: set CXX to a C++ compiler")
    return found


def log_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.log")


def _compile(src: str, name: str, cmd: list[str]) -> str:
    out, log = lib_path(name), log_path(name)
    if os.path.exists(out) and os.path.exists(log) \
            and os.path.getmtime(out) >= os.path.getmtime(src):
        with open(log) as f:
            return f.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([*cmd, "-o", f"{out}.{tag}", src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{cmd[0]} failed on {src}:\n"
                           f"{proc.stdout}{proc.stderr}")
    text = proc.stdout + proc.stderr
    with open(f"{log}.{tag}", "w") as f:
        f.write(text)
    os.replace(f"{log}.{tag}", log)   # the log first: a library that is up
    os.replace(f"{out}.{tag}", out)   # to date always has its log
    return text


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is up to date.  Returns
    the compiler's output (register, spill and shared-memory use per
    kernel) of the build that made the library, now or before."""
    return _compile(os.path.join(CSRC_DIR, f"{name}.cu"), name,
                    [nvcc(), *NVCC_FLAGS])


def build_host(name: str) -> str:
    """Compile the host library ``csrc/<name>.cpp`` with g++ unless it is
    up to date; returns the compiler's output of the build that made the
    library."""
    return _compile(os.path.join(CSRC_DIR, f"{name}.cpp"), name,
                    [gxx(), *GXX_FLAGS])


def load(name: str) -> ctypes.CDLL:
    """The library ``name`` (a ``.cu`` kernel or a ``.cpp`` host library),
    built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if os.path.exists(os.path.join(CSRC_DIR, f"{name}.cu")):
                build(name)
            else:
                build_host(name)
            lib = _libs[name] = ctypes.CDLL(lib_path(name))
        return lib
