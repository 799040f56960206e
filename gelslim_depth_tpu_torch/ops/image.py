"""Difference-image and Gaussian blur ops.

- ``get_difference_image`` re-centers a signed RGB difference into [0, 255]:
  ``((img - base) + 255) / 2`` (ref: processing_utils/image_utils.py:6-10).
- ``blur_depth_images`` applies torchvision's ``gaussian_blur`` with an
  integer kernel size k and the torchvision default sigma
  ``0.3*((k-1)*0.5 - 1) + 0.8`` (ref: processing_utils/image_utils.py:17-19):
  reflect padding and a separable, normalized 1-D Gaussian along each
  spatial axis, here as two banded-matrix contractions in float32, as
  ``gelslim_depth_tpu.ops.image.gaussian_blur`` computes it. k == 1 (the
  shipped configuration) is the identity.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from gelslim_depth_tpu_torch.ops.resize import _highest_matmul_precision


def get_difference_image(tactile_image: torch.Tensor, base_tactile_image: torch.Tensor) -> torch.Tensor:
    """Signed difference re-centered from [-255, 255] into [0, 255]."""
    return (tactile_image - base_tactile_image + 255.0) / 2.0


@functools.lru_cache(maxsize=32)
def _gaussian_kernel_1d(kernel_size: int) -> np.ndarray:
    """torchvision-compatible normalized 1-D Gaussian of odd length k."""
    sigma = 0.3 * ((kernel_size - 1) * 0.5 - 1) + 0.8
    x = np.arange(kernel_size, dtype=np.float64) - (kernel_size - 1) / 2.0
    pdf = np.exp(-0.5 * (x / sigma) ** 2)
    return (pdf / pdf.sum()).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _band_matrix(n_out: int, k: int) -> np.ndarray:
    """(n_out, n_out + k - 1): row i holds the kernel at columns i..i+k-1."""
    kern = _gaussian_kernel_1d(k)
    m = np.zeros((n_out, n_out + k - 1), dtype=np.float32)
    for i in range(n_out):
        m[i, i : i + k] = kern
    return m


def gaussian_blur(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Separable Gaussian blur of the trailing two dims, reflect-padded.

    Accepts (..., H, W). kernel_size must be odd; 1 is a no-op.
    """
    k = int(kernel_size)
    if k <= 1:
        return x
    if k % 2 == 0:
        raise ValueError(f"gaussian_blur kernel_size must be odd, got {k}")
    pad = k // 2
    h, w = x.shape[-2:]
    lead = x.shape[:-2]
    y = x.float().reshape(-1, 1, h, w)  # F.pad's reflect mode wants (N, C, H, W)
    bh = torch.from_numpy(_band_matrix(h, k)).to(x.device)
    bw = torch.from_numpy(_band_matrix(w, k)).to(x.device)
    with _highest_matmul_precision():
        y = torch.einsum("oh,...hw->...ow", bh, F.pad(y, (0, 0, pad, pad), mode="reflect"))
        y = torch.einsum("pw,...ow->...op", bw, F.pad(y, (pad, pad, 0, 0), mode="reflect"))
    return y.reshape(*lead, h, w).to(x.dtype)


def blur_depth_images(depth: torch.Tensor, depth_image_blur_kernel: int) -> torch.Tensor:
    """Name-compatible alias for the reference API
    (ref: processing_utils/image_utils.py:17)."""
    return gaussian_blur(depth, depth_image_blur_kernel)
