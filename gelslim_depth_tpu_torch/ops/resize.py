"""Resizes expressed as two small matrix products, one per spatial axis.

The reference resizes with ``torch.nn.functional.interpolate(mode='area')``
(ref: processing_utils/image_utils.py:12-15), whose semantics are those of
``adaptive_avg_pool2d``: output pixel ``i`` along an axis of input length
``n_in`` and output length ``n_out`` is the uniform average of input pixels
``[floor(i*n_in/n_out), ceil((i+1)*n_in/n_out))``. The shipped pipeline
downsamples 320x427 -> 160x213, where the 427->213 axis is *not* an integer
factor, so windows alternate between 2 and 3 pixels wide; the mm output is
upsampled back 160x213 -> 320x427 with the same window formula.

The JAX package also serves 'bilinear' and 'nearest' through
``jax.image.resize`` ('linear' and 'nearest'), whose weights differ from
``F.interpolate``'s: 'linear' samples at half-pixel centres and, when it
downsamples, widens its triangle filter by the scale (antialiasing), each
output's weights normalized to sum to 1; 'nearest' takes input
``floor((i + 0.5) * n_in / n_out)``, computed in float32. ``weight_matrix``
builds each method's (n_out, n_in) matrix in numpy from those formulas, in
float32 as JAX computes them.

Every method is two float32 contractions. They must not run in TF32: the
resize is parity-critical, so they run at float32 matmul precision
"highest" whatever the caller set, as the JAX package runs them at
``Precision.HIGHEST``. ``resize_rows`` computes a band of output rows from a
band of input rows with the same matrices, for the height-sharded
predictors.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Tuple

import numpy as np
import torch

METHODS = ("area", "bilinear", "nearest")


@functools.lru_cache(maxsize=128)
def _area_weight_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Row-stochastic (n_out, n_in) matrix of adaptive-average-pool weights."""
    w = np.zeros((n_out, n_in), dtype=np.float64)
    for i in range(n_out):
        start = (i * n_in) // n_out
        end = -((-(i + 1) * n_in) // n_out)  # ceil((i+1)*n_in/n_out)
        w[i, start:end] = 1.0 / (end - start)
    return w.astype(np.float32)


def _linear_weight_matrix(n_in: int, n_out: int) -> np.ndarray:
    """``jax.image.resize(..., 'linear')``'s weights (its
    ``compute_weight_mat`` with the triangle kernel, antialias on,
    translation 0), in float32, transposed to (n_out, n_in)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))  # JAX divides the Python floats, then rounds
    kernel_scale = max(inv_scale, f32(1.0))
    # XLA fuses (i + 0.5) * inv_scale - 0.5 into one fused multiply-add:
    # the float32 product is exact in float64, so one rounding of the
    # float64 result is the FMA's
    centre = (np.arange(n_out, dtype=f32) + f32(0.5)).astype(np.float64)
    sample = (centre * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps), w / np.where(total != 0, total, f32(1.0)), 0)
    inside = (sample >= f32(-0.5)) & (sample <= f32(n_in - 0.5))
    return np.where(inside[None, :], w, 0).astype(f32).T.copy()


def _nearest_weight_matrix(n_in: int, n_out: int) -> np.ndarray:
    """One-hot rows at ``jax.image.resize(..., 'nearest')``'s sources,
    ``floor((i + 0.5) * n_in / n_out)`` in float32."""
    f32 = np.float32
    src = np.floor((np.arange(n_out, dtype=f32) + f32(0.5)) * f32(n_in) / f32(n_out)).astype(np.int64)
    w = np.zeros((n_out, n_in), np.float32)
    w[np.arange(n_out), src] = 1.0
    return w


_MATRIX_OF = {"area": _area_weight_matrix, "bilinear": _linear_weight_matrix, "nearest": _nearest_weight_matrix}


@functools.lru_cache(maxsize=256)
def weight_matrix(n_in: int, n_out: int, method: str = "area") -> np.ndarray:
    """The (n_out, n_in) float32 matrix of one axis of ``resize`` by method;
    the identity where n_in == n_out."""
    if method not in _MATRIX_OF:
        raise ValueError(f"interp_method {method!r}: expected one of {METHODS}")
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    return _MATRIX_OF[method](n_in, n_out)


def support(n_in: int, n_out: int, method: str, rows: Tuple[int, int]) -> Tuple[int, int]:
    """The input rows [first, last + 1) that output rows [rows[0], rows[1])
    read (their weights' nonzero columns)."""
    cols = np.nonzero(weight_matrix(n_in, n_out, method)[rows[0]:rows[1]].any(axis=0))[0]
    return int(cols[0]), int(cols[-1]) + 1


@functools.lru_cache(maxsize=256)
def _weight_tensor(n_in: int, n_out: int, method: str, device: torch.device) -> torch.Tensor:
    # kept per device so a serving call copies no weights from the host
    return torch.from_numpy(weight_matrix(n_in, n_out, method)).to(device)


@contextlib.contextmanager
def _highest_matmul_precision():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _contract(x: torch.Tensor, ah: torch.Tensor, aw: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    with _highest_matmul_precision():
        # (..., H_in, W_in) -> (..., H_out, W_in): contract H with A_h.
        y = torch.einsum("oh,...hw->...ow", ah, x.float())
        # (..., H_out, W_in) -> (..., H_out, W_out): contract W with A_w.
        y = torch.einsum("pw,...ow->...op", aw, y)
    return y.to(dtype)


def area_resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Adaptive-average resize of the trailing two spatial dims to ``size``.

    Accepts (..., H, W) tensors. Exactly the semantics of torch
    ``F.interpolate(mode='area')`` / ``adaptive_avg_pool2d``.
    """
    return resize(x, size, "area")


def resize(x: torch.Tensor, size: Tuple[int, int], interp_method: str = "area") -> torch.Tensor:
    """Resize the trailing two dims of (..., H, W) to ``size`` by the named
    method: 'area' (the reference's, and the only shipped one), or
    'bilinear' / 'nearest' as ``jax.image.resize`` computes them."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    h_out, w_out = int(size[0]), int(size[1])
    if interp_method not in METHODS:
        raise ValueError(f"interp_method {interp_method!r}: expected one of {METHODS}")
    if (h_in, w_in) == (h_out, w_out):
        return x
    return _contract(x, _weight_tensor(h_in, h_out, interp_method, x.device),
                     _weight_tensor(w_in, w_out, interp_method, x.device))


def sample_multi_channel_image_to_desired_size(mc_image: torch.Tensor, desired_size: Tuple[int, int],
                                               interp_method: str = "area") -> torch.Tensor:
    """The reference API's name for ``resize`` (ref:
    processing_utils/image_utils.py:12)."""
    return resize(mc_image, desired_size, interp_method)


def resize_rows(x: torch.Tensor, h_in: int, size: Tuple[int, int], out_rows: Tuple[int, int], in_start: int,
                interp_method: str = "area") -> torch.Tensor:
    """Output rows [out_rows[0], out_rows[1]) of ``resize(full, size)``,
    where full has h_in rows and x holds its rows [in_start, in_start +
    x.shape[-2]), every row those output rows read (``support``): the
    global matrix's block, so each output row has the weights it has in
    the whole resize."""
    o0, o1 = out_rows
    lo, hi = support(h_in, int(size[0]), interp_method, out_rows)
    if lo < in_start or hi > in_start + x.shape[-2]:
        raise ValueError(f"resize_rows: output rows {out_rows} read input rows [{lo}, {hi}), "
                         f"x holds [{in_start}, {in_start + x.shape[-2]})")
    ah = _weight_tensor(h_in, int(size[0]), interp_method, x.device)[o0:o1, in_start:in_start + x.shape[-2]]
    return _contract(x, ah, _weight_tensor(x.shape[-1], int(size[1]), interp_method, x.device))
