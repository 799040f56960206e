"""The plain reference of dual-frame serving, float32 with TF32 off: the
difference image against the base frame, the area resize to the network's
input, the image normalization, the U-Net (``reference.unet``), the depth
denormalization and the area resize back to the frame, as the published
inference chain composes them (resize -> normalize -> U-Net ->
denormalize -> resize back)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import unet


def network_input(cfg: dict, frames: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """(n, 6, H, W) dual frames and a (6, H, W) base in [0, 255] -> the
    (2n, 3, h, w) normalized input, the left fingers' rows first."""
    n, _, fh, fw = frames.shape
    fingers = frames.reshape(n, 2, 3, fh, fw)
    if cfg["use_difference_image"]:
        fingers = (fingers - base.reshape(1, 2, 3, fh, fw) + 255.0) / 2.0
    fingers = fingers.transpose(0, 1).reshape(2 * n, 3, fh, fw)
    if cfg["interp_method"] != "area":
        raise ValueError(f"the reference resizes by area only, not {cfg['interp_method']!r}")
    x = F.interpolate(fingers, size=tuple(cfg["input_tactile_image_size"]), mode="area")
    if cfg["image_normalization_method"] != "0_255_to_0_1":
        raise ValueError(f"the reference has no image normalization {cfg['image_normalization_method']!r}")
    return x / 255.0


def depth_mm(cfg: dict, y: torch.Tensor, n: int) -> torch.Tensor:
    """(2n, 1, h, w) network output, left fingers first -> (n, 2, H, W) mm."""
    if cfg["depth_normalization_method"] != "min_max_to_0_-1":
        raise ValueError(f"the reference has no depth normalization {cfg['depth_normalization_method']!r}")
    lo, hi = cfg["depth_normalization_parameters"]
    d = y * (hi - lo) / (-cfg["norm_scale"]) + lo
    d = F.interpolate(d, size=tuple(cfg["frame_size"]), mode="area")
    return d.reshape(2, n, *cfg["frame_size"]).transpose(0, 1)


@torch.no_grad()
def predict(cfg: dict, sd, frames: torch.Tensor, base: torch.Tensor, quant=None,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(n, 6, H, W) dual frames -> (n, 2, H, W) depth in mm; the U-Net in
    dtype (``unet.forward``), the rest in float32."""
    with unet.no_tf32():
        y = unet.forward(cfg, sd, network_input(cfg, frames, base), quant=quant, dtype=dtype)
        return depth_mm(cfg, y, frames.shape[0])


@torch.no_grad()
def calibrate(cfg: dict, sd, calib_frames: torch.Tensor, base: torch.Tensor, levels: int) -> unet.Quant:
    """The int8 scheme's activation scales from the calibration dual
    frames, worked out again from the float32 forward."""
    with unet.no_tf32():
        return unet.calibrate(cfg, sd, network_input(cfg, calib_frames, base), levels)
