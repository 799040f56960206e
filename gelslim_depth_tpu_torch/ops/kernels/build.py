"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
with ``nvcc`` for ``sm_90a`` into ``gelslim_depth_tpu_torch/_build/``, under
a file name carrying the source's hash, so an edited source is rebuilt and
an unchanged one is loaded as it is. Nothing is built when the package is
imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc") or (CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc"))
    if not path or not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def library_path(name: str) -> str:
    """Build csrc/<name>.cu unless a build of this exact source exists."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The built csrc/<name>.cu, loaded once per process."""
    return ctypes.CDLL(library_path(name))
