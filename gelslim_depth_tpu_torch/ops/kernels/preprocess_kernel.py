"""Fused dual-finger preprocess: difference image -> area resize ->
per-channel normalize, over (N, 6, H, W) float32 frames.

``fused_preprocess_dual`` launches the hand-written CUDA kernel
``csrc/fused_preprocess_dual.cu`` for tensors on a CUDA device (the source's
header says what it replaces, what bounds it and how it is laid out), and
computes ``fused_preprocess_dual_reference``, the same function composed of
plain PyTorch ops, for tensors on the CPU. There is no fallback from the
kernel to the plain version: on CUDA it launches or raises.

The output batch layout matches the reference's finger split
(``cat([left, right], dim=0)``, ref general_dataset.py:70-77): left-finger
samples occupy rows [0, N), right-finger rows [N, 2N).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gelslim_depth_tpu_torch.ops.image import get_difference_image
from gelslim_depth_tpu_torch.ops.resize import area_resize


@functools.cache
def _kernel_fn():
    from gelslim_depth_tpu_torch.ops.kernels.build import load_library

    fn = load_library("fused_preprocess_dual").fused_preprocess_dual
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, i, i, i, i, i, i, f, f, f, f, f, f, p]
    fn.restype = ctypes.c_int
    return fn


def _coeffs(v: Sequence[float], name: str) -> Tuple[float, float, float]:
    v = np.asarray(v, np.float32).reshape(-1)
    if v.shape != (3,):
        raise ValueError(f"{name} must hold 3 per-channel values, got shape {v.shape}")
    return tuple(float(x) for x in v)


def fused_preprocess_dual(
    frames: torch.Tensor,           # (N, 6, H, W) float32
    base: Optional[torch.Tensor],   # (6, H, W) float32; may be None when use_diff=False
    mult: Sequence[float],          # (3,) per-channel normalize multiplier
    add: Sequence[float],           # (3,) per-channel normalize offset
    *,
    out_size: Tuple[int, int],
    use_diff: bool = True,
) -> torch.Tensor:
    """(N, 6, H, W) + base -> (2N, 3, h, w) normalized finger images.

    On CUDA the output is allocated with ``torch.empty`` and the kernel is
    launched on the current stream without synchronizing; each launch adds
    one to ``fused_preprocess_dual.launches`` (an empty batch launches
    nothing). CPU tensors go through
    ``fused_preprocess_dual_reference`` and launch nothing."""
    if frames.ndim != 4 or frames.shape[1] != 6:
        raise ValueError(f"frames must be (N, 6, H, W), got {tuple(frames.shape)}")
    n, _, h_in, w_in = frames.shape
    h_out, w_out = int(out_size[0]), int(out_size[1])
    if h_out < 1 or w_out < 1:
        raise ValueError(f"out_size must be positive, got {out_size}")
    if frames.dtype != torch.float32:
        raise TypeError(f"frames must be float32, got {frames.dtype}")
    if use_diff:
        if base is None or tuple(base.shape) != (6, h_in, w_in):
            raise ValueError(
                f"base must be (6, {h_in}, {w_in}) with use_diff, got "
                f"{None if base is None else tuple(base.shape)}"
            )
        if base.dtype != torch.float32 or base.device != frames.device:
            raise TypeError("base must be float32 on the frames' device")
    mult, add = _coeffs(mult, "mult"), _coeffs(add, "add")

    if frames.device.type == "cpu":
        return fused_preprocess_dual_reference(
            frames, base, mult, add, out_size=(h_out, w_out), use_diff=use_diff
        )
    if frames.device.type != "cuda":
        raise ValueError(f"no kernel for device {frames.device}")
    if not frames.is_contiguous() or (use_diff and not base.is_contiguous()):
        raise ValueError("frames and base must be contiguous")

    out = torch.empty((2 * n, 3, h_out, w_out), dtype=torch.float32, device=frames.device)
    if n == 0:
        return out
    with torch.cuda.device(frames.device):
        err = _kernel_fn()(
            frames.data_ptr(), base.data_ptr() if use_diff else None, out.data_ptr(),
            n, h_in, w_in, h_out, w_out, int(bool(use_diff)), *mult, *add,
            torch.cuda.current_stream(frames.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_preprocess_dual kernel launch failed: CUDA error {err}")
    fused_preprocess_dual.launches += 1
    return out


fused_preprocess_dual.launches = 0


def fused_preprocess_dual_reference(frames, base, mult, add, *, out_size, use_diff=True):
    """Plain PyTorch composition of the same function (the kernel's twin)."""
    n, _, h_in, w_in = frames.shape
    # (N, 2, 3, H, W) -> (2, N, 3, H, W): left fingers first, then right
    fingers = frames.reshape(n, 2, 3, h_in, w_in).transpose(0, 1)
    if use_diff:
        fingers = get_difference_image(fingers, base.reshape(2, 1, 3, h_in, w_in))
    resized = area_resize(fingers.reshape(2 * n, 3, h_in, w_in), out_size)
    m = torch.as_tensor(np.asarray(mult, np.float32), device=frames.device).reshape(1, 3, 1, 1)
    a = torch.as_tensor(np.asarray(add, np.float32), device=frames.device).reshape(1, 3, 1, 1)
    return resized * m + a
