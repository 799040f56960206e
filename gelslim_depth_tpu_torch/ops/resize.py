"""Area (adaptive-average) resize expressed as two small matrix products.

The reference resizes with ``torch.nn.functional.interpolate(mode='area')``
(ref: processing_utils/image_utils.py:12-15), whose semantics are those of
``adaptive_avg_pool2d``: output pixel ``i`` along an axis of input length
``n_in`` and output length ``n_out`` is the uniform average of input pixels
``[floor(i*n_in/n_out), ceil((i+1)*n_in/n_out))``. The shipped pipeline
downsamples 320x427 -> 160x213, where the 427->213 axis is *not* an integer
factor, so windows alternate between 2 and 3 pixels wide; the mm output is
upsampled back 160x213 -> 320x427 with the same window formula.

Each axis gets a row-stochastic (n_out, n_in) weight matrix, and the resize
is two float32 contractions. They must not run in TF32: the resize is
parity-critical, so they run at float32 matmul precision "highest" whatever
the caller set, as the JAX package runs them at ``Precision.HIGHEST``.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=128)
def _area_weight_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Row-stochastic (n_out, n_in) matrix of adaptive-average-pool weights."""
    w = np.zeros((n_out, n_in), dtype=np.float64)
    for i in range(n_out):
        start = (i * n_in) // n_out
        end = -((-(i + 1) * n_in) // n_out)  # ceil((i+1)*n_in/n_out)
        w[i, start:end] = 1.0 / (end - start)
    return w.astype(np.float32)


@functools.lru_cache(maxsize=128)
def _area_weight_tensor(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    # kept per device so a serving call copies no weights from the host
    return torch.from_numpy(_area_weight_matrix(n_in, n_out)).to(device)


@contextlib.contextmanager
def _highest_matmul_precision():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def area_resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Adaptive-average resize of the trailing two spatial dims to ``size``.

    Accepts (..., H, W) tensors. Exactly the semantics of torch
    ``F.interpolate(mode='area')`` / ``adaptive_avg_pool2d``.
    """
    h_in, w_in = x.shape[-2], x.shape[-1]
    h_out, w_out = int(size[0]), int(size[1])
    if (h_in, w_in) == (h_out, w_out):
        return x
    dtype = x.dtype
    ah = _area_weight_tensor(h_in, h_out, x.device)
    aw = _area_weight_tensor(w_in, w_out, x.device)
    with _highest_matmul_precision():
        # (..., H_in, W_in) -> (..., H_out, W_in): contract H with A_h.
        y = torch.einsum("oh,...hw->...ow", ah, x.float())
        # (..., H_out, W_in) -> (..., H_out, W_out): contract W with A_w.
        y = torch.einsum("pw,...ow->...op", aw, y)
    return y.to(dtype)


def resize(x: torch.Tensor, size: Tuple[int, int], interp_method: str = "area") -> torch.Tensor:
    """Resize trailing two dims by the named method.

    'area' is the reference's (and only shipped) method. The JAX package
    serves 'bilinear' and 'nearest' through ``jax.image.resize``, whose
    semantics differ from ``F.interpolate``; they are not ported yet.
    """
    if interp_method == "area":
        return area_resize(x, size)
    raise NotImplementedError(
        f"interp_method {interp_method!r}: only 'area' is ported; "
        "'bilinear' and 'nearest' are not"
    )
