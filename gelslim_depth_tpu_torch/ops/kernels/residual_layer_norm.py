"""A ViT block's LayerScale residual add and the LayerNorm after it, as one
hand-written kernel.

``residual_layer_norm`` checks its arguments. On a CUDA tensor it launches
``csrc/residual_layer_norm.cu`` (the source's header says what it
replaces, what bounds it and how it is laid out); on a CPU tensor it
computes ``residual_layer_norm_reference``, its plain twin, the
``torch.addcmul`` and ``F.layer_norm`` that the encoder's blocks ran
before. There is no fallback from the kernel to the library: on CUDA it
launches or raises.

The kernel computes the residual add in aten's float32 arithmetic, so its
``x_new`` equals ``addcmul``'s bit for bit; it takes the LayerNorm's
statistics in float32 from the rounded ``x_new`` in its own order, so its
``y`` may differ from ``F.layer_norm``'s by a rounding.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

MAX_D = 2048  # csrc/residual_layer_norm.cu's kMaxD: 8 vectors of 8 a lane
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def bind(lib: ctypes.CDLL):
    """The C entry of a built csrc/residual_layer_norm.cu, typed."""
    fn = lib.residual_layer_norm
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 7 + [ctypes.c_longlong, i, ctypes.c_float, i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel_fn():
    from gelslim_depth_tpu_torch.ops.kernels.build import load_library

    return bind(load_library("residual_layer_norm"))


def _check(x, branch, gamma, weight, bias) -> None:
    tensors = {"x": x, "branch": branch, "gamma": gamma, "weight": weight, "bias": bias}
    if not x.is_floating_point() or x.ndim < 1:
        raise TypeError(f"x must be a floating (..., D) tensor, got {x.dtype} {tuple(x.shape)}")
    for name, t in tensors.items():
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"{name} must be x's dtype and device, got {t.dtype} on {t.device}")
    d = x.shape[-1]
    if branch.shape != x.shape or any(t.shape != (d,) for t in (gamma, weight, bias)):
        raise ValueError(f"branch must be x's shape {tuple(x.shape)} and gamma, weight, bias ({d},), got "
                         f"{tuple(branch.shape)}, {tuple(gamma.shape)}, {tuple(weight.shape)}, {tuple(bias.shape)}")
    if d % 8 or not 8 <= d <= MAX_D:
        raise ValueError(f"D must be a multiple of 8 in [8, {MAX_D}], got {d}")
    if not all(t.is_contiguous() for t in tensors.values()):
        raise ValueError("x, branch, gamma, weight and bias must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors.values()):
        raise RuntimeError("the kernel has no backward: call it under torch.no_grad() or on detached tensors")
    if x.is_cuda:
        if x.dtype not in KERNEL_DTYPES:
            raise TypeError(f"on CUDA the kernel takes float32 or bfloat16, got {x.dtype}")
        if any(t.data_ptr() % 16 for t in tensors.values()):
            raise ValueError("on CUDA every tensor must start 16-byte aligned")


def residual_layer_norm(x: torch.Tensor, branch: torch.Tensor, gamma: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x_new, y)``: ``x_new = torch.addcmul(x, branch, gamma)`` and ``y =
    F.layer_norm(x_new, (D,), weight, bias, eps)``, of x and branch
    ``(..., D)`` and gamma, weight, bias ``(D,)``, one dtype, contiguous,
    D a multiple of 8 up to ``MAX_D``.

    It refuses, on every device, a tensor that needs a gradient under grad
    mode (the kernel has no backward). On CUDA the dtype must be float32 or
    bfloat16 and every tensor 16-byte aligned; it allocates both outputs
    with ``torch.empty_like``, launches the kernel on the current stream
    without synchronizing and adds one to ``residual_layer_norm.launches``
    (an empty x launches nothing). On the CPU it computes
    ``residual_layer_norm_reference``."""
    _check(x, branch, gamma, weight, bias)
    if not x.is_cuda:
        return residual_layer_norm_reference(x, branch, gamma, weight, bias, eps)
    x_new, y = torch.empty_like(x), torch.empty_like(x)
    if x.numel():
        dev = x.get_device()
        err = _kernel_fn()(
            x.data_ptr(), branch.data_ptr(), gamma.data_ptr(), weight.data_ptr(), bias.data_ptr(), x_new.data_ptr(),
            y.data_ptr(), x.numel() // x.shape[-1], x.shape[-1], eps, x.dtype == torch.bfloat16, dev,
            torch._C._cuda_getCurrentRawStream(dev),
        )
        if err != 0:
            raise RuntimeError(f"residual_layer_norm kernel launch failed: CUDA error {err}")
        residual_layer_norm.launches += 1
    return x_new, y


residual_layer_norm.launches = 0


def residual_layer_norm_reference(x: torch.Tensor, branch: torch.Tensor, gamma: torch.Tensor, weight: torch.Tensor,
                                  bias: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the same function (the kernel's twin): the
    LayerScale residual add as one ``addcmul``, then the library's
    LayerNorm of the sum."""
    x_new = torch.addcmul(x, branch, gamma)
    return x_new, F.layer_norm(x_new, (x.shape[-1],), weight, bias, eps)
