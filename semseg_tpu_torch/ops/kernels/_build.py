"""Build and load the port's hand-written CUDA kernels.

Each kernel is a ``.cu`` file under ``semseg_tpu_torch/csrc`` with a plain C
interface. At its first CUDA call the wrapper asks for its library here:
``nvcc`` compiles the sources for Hopper (``sm_90a``) into a shared library
under ``build/semseg_tpu_torch_kernels/<hash of sources and flags>/`` of
the checkout, which ``ctypes`` loads. A library already built from the same
sources and flags is reused. Nothing is built at import time, so the package
imports on a machine with neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "semseg_tpu_torch_kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (searched PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
        "the port's CUDA kernels are built from source at first use"
    )


def library_path(name: str, sources) -> str:
    """Where the library for ``sources`` and the current flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            h.update(src.encode() + b"\0" + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], f"lib{name}.so")


def load_library(name: str, sources) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>.so`` from ``csrc/<sources>``.

    Raises if ``nvcc`` is missing or the build fails; there is no fallback.
    """
    key = (name, tuple(sources))
    with _lock:
        lib = _loaded.get(key)
        if lib is not None:
            return lib
        so = library_path(name, sources)
        if not os.path.exists(so):
            _compile(so, sources)
        lib = ctypes.CDLL(so)
        _loaded[key] = lib
        return lib


def _compile(so: str, sources) -> None:
    os.makedirs(os.path.dirname(so), exist_ok=True)
    # Build under a temporary name and rename into place, so a second
    # process never loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC_DIR, s) for s in sources)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
