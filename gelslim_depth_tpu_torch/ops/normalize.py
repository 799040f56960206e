"""(De)normalization ops for tactile images and depth maps.

Matches the reference's 4 image methods and 4 depth methods
(ref: processing_utils/normalization_utils.py:4-130). Each method is folded
into a single per-channel affine ``y = x * mult + add`` whose coefficients
are computed in float64 numpy, with the reference's short-param-list
broadcast rule ``params[min(i, len-1)]``, then applied in float32.

Image methods ('normalize' direction is ``scale * (x - bias) / denom``):
- 'min_max_to_-1_1': scale=norm_scale, bias=(max+min)/2, denom=max-min (per ch)
- 'mean_std':        scale=1,          bias=mean,        denom=std     (per ch)
- '0_255_to_-1_1':   scale=2,          bias=127.5,       denom=255
- '0_255_to_0_1':    scale=1,          bias=0,           denom=255

Depth methods (scalar coefficients; params tuple is (min, max[, mean, std])):
- 'min_max_to_-1_1': scale=norm_scale,  bias=(max+min)/2, denom=max-min
- 'mean_std':        scale=1,           bias=mean,        denom=std
- 'min_max_to_0_1':  scale=norm_scale,  bias=min,         denom=max-min
- 'min_max_to_0_-1': scale=-norm_scale, bias=min,         denom=max-min
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

IMAGE_NORMALIZATION_METHODS = ("min_max_to_-1_1", "mean_std", "0_255_to_-1_1", "0_255_to_0_1")
DEPTH_NORMALIZATION_METHODS = ("min_max_to_-1_1", "mean_std", "min_max_to_0_1", "min_max_to_0_-1")


def _broadcast_params(vals: Sequence[float], num_channels: int) -> np.ndarray:
    """Reference broadcast rule: channel i reads params[min(i, len-1)]."""
    vals = list(vals)
    return np.asarray([vals[min(i, len(vals) - 1)] for i in range(num_channels)], dtype=np.float64)


def image_norm_coeffs(
    method: str,
    norm_scale: Optional[float],
    params,  # (mins, maxes, means, stds) per-channel lists, or None for 0_255 methods
    num_channels: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-channel (scale, bias, denominator) float64 vectors of length C."""
    if method == "min_max_to_-1_1":
        mins, maxes, _, _ = params
        scale = np.full(num_channels, float(norm_scale))
        bias = 0.5 * (_broadcast_params(maxes, num_channels) + _broadcast_params(mins, num_channels))
        denom = _broadcast_params(maxes, num_channels) - _broadcast_params(mins, num_channels)
    elif method == "mean_std":
        _, _, means, stds = params
        scale = np.ones(num_channels)
        bias = _broadcast_params(means, num_channels)
        denom = _broadcast_params(stds, num_channels)
    elif method == "0_255_to_-1_1":
        scale = np.full(num_channels, 2.0)
        bias = np.full(num_channels, 127.5)
        denom = np.full(num_channels, 255.0)
    elif method == "0_255_to_0_1":
        scale = np.ones(num_channels)
        bias = np.zeros(num_channels)
        denom = np.full(num_channels, 255.0)
    else:
        raise ValueError(f"Unknown image normalization method: {method!r}")
    return scale, bias, denom


def depth_norm_coeffs(
    method: str, norm_scale: Optional[float], params
) -> Tuple[float, float, float]:
    """Scalar (scale, bias, denominator) for a depth method."""
    vals = list(params) if params is not None else []
    min_d = vals[0] if len(vals) > 0 else None
    max_d = vals[1] if len(vals) > 1 else None
    mean_d = vals[2] if len(vals) > 2 else None
    std_d = vals[3] if len(vals) > 3 else None
    if method == "min_max_to_-1_1":
        return float(norm_scale), 0.5 * (max_d + min_d), max_d - min_d
    if method == "mean_std":
        return 1.0, float(mean_d), float(std_d)
    if method == "min_max_to_0_1":
        return float(norm_scale), float(min_d), max_d - min_d
    if method == "min_max_to_0_-1":
        return -float(norm_scale), float(min_d), max_d - min_d
    raise ValueError(f"Unknown depth normalization method: {method!r}")


def _apply_affine(x: torch.Tensor, mult: np.ndarray, add: np.ndarray) -> torch.Tensor:
    if x.ndim < 3:
        raise ValueError(f"expected (..., C, H, W), got shape {tuple(x.shape)}")
    shape = (x.shape[-3], 1, 1)
    m = torch.as_tensor(mult.astype(np.float32), device=x.device).reshape(shape)
    a = torch.as_tensor(add.astype(np.float32), device=x.device).reshape(shape)
    return x * m + a


def normalize_tactile_image(
    tactile_image: torch.Tensor,
    image_normalization_method: str,
    norm_scale: Optional[float] = None,
    image_normalization_parameters=None,
) -> torch.Tensor:
    """normalize: scale*(x - bias)/denom, folded to x*mult + add per channel."""
    c = tactile_image.shape[-3]
    scale, bias, denom = image_norm_coeffs(
        image_normalization_method, norm_scale, image_normalization_parameters, c
    )
    return _apply_affine(tactile_image, scale / denom, -bias * scale / denom)


def denormalize_tactile_image(
    tactile_image: torch.Tensor,
    image_normalization_method: str,
    norm_scale: Optional[float] = None,
    image_normalization_parameters=None,
) -> torch.Tensor:
    """denormalize: x*denom/scale + bias."""
    c = tactile_image.shape[-3]
    scale, bias, denom = image_norm_coeffs(
        image_normalization_method, norm_scale, image_normalization_parameters, c
    )
    return _apply_affine(tactile_image, denom / scale, bias)


def normalize_depth_image(
    depth_image: torch.Tensor,
    depth_normalization_method: str,
    norm_scale: Optional[float] = None,
    depth_normalization_parameters=None,
) -> torch.Tensor:
    scale, bias, denom = depth_norm_coeffs(
        depth_normalization_method, norm_scale, depth_normalization_parameters
    )
    return depth_image * (scale / denom) + (-bias * scale / denom)


def denormalize_depth_image(
    depth_image: torch.Tensor,
    depth_normalization_method: str,
    norm_scale: Optional[float] = None,
    depth_normalization_parameters=None,
) -> torch.Tensor:
    scale, bias, denom = depth_norm_coeffs(
        depth_normalization_method, norm_scale, depth_normalization_parameters
    )
    return depth_image * (denom / scale) + bias
