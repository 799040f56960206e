"""The DPT head's bilinear resize with ``align_corners=True`` on
channels-last maps, as one hand-written kernel.

``bilinear_resize`` checks its arguments. On a CUDA tensor it launches
``csrc/bilinear_resize.cu`` (the source's header says what it replaces,
what bounds it and how it is laid out); on a CPU tensor it computes
``bilinear_resize_reference``, its plain twin, the ``F.interpolate`` call
the head made before. There is no fallback from the
kernel to the library: on CUDA it launches or raises.

The kernel computes in aten's float32 arithmetic and order, with the fused
multiply-adds of aten's build, and rounds once, so on the card it equals
``F.interpolate`` bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def bind(lib: ctypes.CDLL):
    """The C entry of a built csrc/bilinear_resize.cu, typed."""
    fn = lib.bilinear_resize
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p] + [i] * 8 + [p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel_fn():
    from gelslim_depth_tpu_torch.ops.kernels.build import load_library

    return bind(load_library("bilinear_resize"))


def _check(x: torch.Tensor, size: Sequence[int]) -> Tuple[int, int]:
    if x.ndim != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be a float32 or bfloat16 (N, C, H, W) tensor, got {x.dtype} {tuple(x.shape)}")
    size = tuple(int(s) for s in size)
    if len(size) != 2 or min(size) < 1:
        raise ValueError(f"size must be two positive ints (H, W), got {size}")
    if min(x.shape[2:]) < 1:
        raise ValueError(f"x must have a positive height and width, got {tuple(x.shape)}")
    if x.is_cuda and not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("on CUDA, x must be channels-last in memory")
    if x.is_cuda and x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("the CUDA kernel has no backward: call it under torch.no_grad() or on a detached x")
    return size


def bilinear_resize(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """``F.interpolate(x, size, mode="bilinear", align_corners=True)`` of a
    float32 or bfloat16 ``(N, C, H, W)`` tensor, in its dtype.

    On CUDA x must be channels-last in memory and must not need a
    gradient (the kernel has no backward, so it raises rather than cut the
    graph); it allocates the
    channels-last output with ``torch.empty``, launches the kernel on the
    current stream without synchronizing and adds one to
    ``bilinear_resize.launches`` (an empty x launches nothing). On the CPU
    it computes ``bilinear_resize_reference`` in x's layout."""
    size = _check(x, size)
    if not x.is_cuda:
        return bilinear_resize_reference(x, size)
    out = torch.empty((x.shape[0], x.shape[1], *size), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel():
        n, c, h, w = x.shape
        dev = x.get_device()
        err = _kernel_fn()(
            x.data_ptr(), out.data_ptr(), n, c, h, w, size[0], size[1], x.dtype == torch.bfloat16, dev,
            torch._C._cuda_getCurrentRawStream(dev),
        )
        if err != 0:
            raise RuntimeError(f"bilinear_resize kernel launch failed: CUDA error {err}")
        bilinear_resize.launches += 1
    return out


bilinear_resize.launches = 0


def bilinear_resize_reference(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version of the same function (the kernel's twin): the
    library's bilinear interpolation with ``align_corners=True``."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)
