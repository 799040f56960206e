"""ctypes wrapper for the host C++ depth renderer (``csrc/meshrender.cpp``).

The same algorithm as ``depth_render.render_depth_batch`` on the host CPU,
one sample per thread; an offline data-prep pass whose inputs and outputs
live in ``.pt`` files on the host can render there without a card. The
library is built with ``g++`` at first use (``ops/kernels/build.py``); a
failed build or load raises, and nothing falls back to another renderer.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np

from gelslim_depth_tpu_torch.ops.kernels import build


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load_library("meshrender")
    lib.render_depth_batch_native.restype = ctypes.c_int
    lib.render_depth_batch_native.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,   # pc, P
        ctypes.POINTER(ctypes.c_float),                   # poses
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,   # widths, B
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # spec
        ctypes.c_int, ctypes.c_int,                       # H, W
        ctypes.c_float, ctypes.c_int,                     # mm_per_pixel, fill_iters
        ctypes.c_int, ctypes.c_int,                       # invert, lr_flip
        ctypes.POINTER(ctypes.c_float),                   # out
        ctypes.c_int,                                     # n_threads
    ]
    return lib


def render_depth_batch_native(
    pc: np.ndarray,        # (P, 3) mm
    poses: np.ndarray,     # (B, 3) rows (t1, t2, angle); t1/t2 in METERS
    widths: np.ndarray,    # (B,) mm
    *,
    spec,
    image_size: Tuple[int, int] = (320, 427),
    mm_per_pixel: float = 12.0 / 320.0,
    fill_iters: int = 6,
    invert_affine: bool = False,
    lr_flip: bool = False,
    n_threads: int = 0,
) -> np.ndarray:
    """Same contract as depth_render.render_depth_batch (meters -> mm x1000
    on the translations, (B, 2, H, W) output, (left, right) channel order
    unless lr_flip), as a float32 numpy array. n_threads 0 uses every
    core."""
    pc = np.ascontiguousarray(pc, np.float32)
    poses = np.array(np.asarray(poses, np.float32)[:, :3])  # a contiguous copy
    poses[:, :2] *= 1000.0  # meters -> mm, matching the torch path's x1000
    widths = np.ascontiguousarray(widths, np.float32).reshape(-1)
    if pc.ndim != 2 or pc.shape[1] != 3 or pc.shape[0] == 0:
        raise ValueError(f"pc: want (P, 3) with P > 0, got {pc.shape}")
    if poses.shape[0] != widths.shape[0] or poses.shape[0] == 0:
        raise ValueError(f"poses {poses.shape} and widths {widths.shape}: want B > 0 of each")
    h, w = int(image_size[0]), int(image_size[1])
    out = np.empty((poses.shape[0], 2, h, w), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    rc = _lib().render_depth_batch_native(
        pc.ctypes.data_as(fp), pc.shape[0],
        poses.ctypes.data_as(fp),
        widths.ctypes.data_as(fp), poses.shape[0],
        int(spec.perp), int(spec.aligned), int(spec.unaligned), int(spec.multiplier),
        h, w, float(mm_per_pixel), int(fill_iters),
        int(bool(invert_affine)), int(bool(lr_flip)),
        out.ctypes.data_as(fp), int(n_threads),
    )
    if rc != 0:
        raise RuntimeError(f"render_depth_batch_native returned {rc}")
    return out
