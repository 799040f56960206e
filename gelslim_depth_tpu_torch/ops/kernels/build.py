"""Build the hand-written CUDA kernels, and the host C++ renderer, and load
them with ctypes.

Each ``csrc/<name>.cu`` or ``csrc/<name>.cpp`` has a plain C interface. At
first use it is compiled, a ``.cu`` with ``nvcc`` for ``sm_90a`` and a
``.cpp`` with ``g++``, into ``gelslim_depth_tpu_torch/_build/``, under a
file name carrying the source's hash, so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing is built when the package is
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
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc") or (CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc"))
    if not path or not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def _paths(name: str):
    """(source, its flags, library file named by the source's and flags'
    hash): csrc/<name>.cu, else csrc/<name>.cpp."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    flags = NVCC_FLAGS
    if not os.path.exists(src):
        src, flags = os.path.join(CSRC_DIR, f"{name}.cpp"), GXX_FLAGS
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    return src, flags, os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build_all(names) -> dict:
    """Build every csrc/<name> source that has no build of its exact source
    yet, one compiler process each, all started together; returns {name:
    library}."""
    libs, jobs = {}, []
    for name in names:
        src, flags, lib = _paths(name)
        libs[name] = lib
        if not os.path.exists(lib):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc() if flags is NVCC_FLAGS else "g++", *flags, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            jobs.append((src, lib, tmp, proc))
    failed = []
    for src, lib, tmp, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
        else:
            failed.append(f"failed to build {src}:\n{log}")
        if os.path.exists(tmp):
            os.remove(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def library_path(name: str) -> str:
    """Build csrc/<name> unless a build of this exact source exists."""
    return build_all([name])[name]


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The built csrc/<name>, loaded once per process."""
    return ctypes.CDLL(library_path(name))
