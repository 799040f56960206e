"""Fused inference: the deployable RGB -> mm-depth chain, in PyTorch.

The reference's inference chain is resize -> normalize -> UNet ->
denormalize -> resize-back (ref test_utils/test_depth_estimation.py:14-20,
processing_utils/complete_prediction.py:4-10), optionally preceded by the
dual-finger base-image subtraction. On a CUDA device the dual-frame path
runs its diff + resize + normalize front end as one hand-written kernel
(``ops.kernels.fused_preprocess_dual``), the U-Net as cuDNN convolutions,
and the denormalize + resize-back as plain tensor ops.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device they raise rather than run on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gelslim_depth_tpu_torch import ops
from gelslim_depth_tpu_torch.config import GelslimConfig
from gelslim_depth_tpu_torch.models.unet import UNet


def fused_predict(
    config: GelslimConfig, net: UNet, images: torch.Tensor, output_size: Tuple[int, int]
) -> torch.Tensor:
    """resize -> normalize -> UNet(eval) -> denormalize -> resize-back.

    images: (N, 3, H, W) tactile (or difference) images in [0, 255].
    Returns (N, 1, *output_size) depth in mm (<= 0).
    """
    x = ops.resize(images, config.input_tactile_image_size, config.interp_method)
    x = ops.normalize_tactile_image(
        x, config.image_normalization_method, config.norm_scale, config.image_normalization_parameters
    )
    return _postprocess(config, net(x), output_size)


def _postprocess(config: GelslimConfig, y: torch.Tensor, output_size) -> torch.Tensor:
    y = ops.denormalize_depth_image(
        y, config.depth_normalization_method, config.norm_scale, config.depth_normalization_parameters
    )
    return ops.resize(y, output_size, config.interp_method)


def dual_frames_to_fingers(
    config: GelslimConfig, frames: torch.Tensor, base_frame: Optional[torch.Tensor]
) -> torch.Tensor:
    """(N, 6, H, W) dual frames -> (2N, 3, H, W) per-finger images after the
    configured difference-image step (rows interleave frame-left/frame-right).
    base_frame is (6, H, W) or (N, 6, H, W)."""
    n, _, h, w = frames.shape
    fingers = frames.reshape(n, 2, 3, h, w)
    if config.use_difference_image and base_frame is not None:
        fingers = ops.get_difference_image(fingers, base_frame.reshape(-1, 2, 3, h, w))
    return fingers.reshape(2 * n, 3, h, w)


def fused_predict_dual(
    config: GelslimConfig,
    net: UNet,
    frames: torch.Tensor,
    base_frame: Optional[torch.Tensor],
    output_size: Tuple[int, int],
    *,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """Full dual-GelSlim frame path: (N, 6, H, W) raw frames (left 0:3,
    right 3:6) -> per-finger difference vs base_frame (6, H, W) or (N, 6,
    H, W) -> both fingers batched through the network -> (N, 2, *output_size)
    mm depth.

    use_kernel routes the diff+resize+normalize front end through
    ``fused_preprocess_dual``; None takes it when the frames are on CUDA.
    The kernel hard-wires the area resize and a shared (6, H, W) base, so
    another interp_method or a batched (N, 6, H, W) base takes the composed
    path."""
    n = frames.shape[0]
    if use_kernel is None:
        use_kernel = frames.is_cuda
    use_kernel = use_kernel and config.interp_method == "area"
    if use_kernel and (base_frame is None or base_frame.ndim == 3):
        from gelslim_depth_tpu_torch.ops.kernels import fused_preprocess_dual

        scale, bias, denom = ops.image_norm_coeffs(
            config.image_normalization_method, config.norm_scale,
            config.image_normalization_parameters, 3,
        )
        use_diff = bool(config.use_difference_image and base_frame is not None)
        x = fused_preprocess_dual(
            frames.contiguous(),
            base_frame.contiguous() if use_diff else None,
            (scale / denom).astype(np.float32),
            (-bias * scale / denom).astype(np.float32),
            out_size=config.input_tactile_image_size,
            use_diff=use_diff,
        )
        depth = _postprocess(config, net(x), output_size)
        # kernel layout: rows [0, n) = left finger, [n, 2n) = right
        return torch.stack([depth[:n, 0], depth[n:, 0]], dim=1)
    fingers = dual_frames_to_fingers(config, frames, base_frame)
    depth = fused_predict(config, net, fingers, output_size)
    return depth.reshape(n, 2, *output_size)


class Predictor:
    """Bundles config + weights into single-finger and dual-frame
    predictors on one device.

    The reference's external-API contract (README.md:130-178): build model
    from a config module, load weights, call predict_depth_from_RGB:

        cfg = GelslimConfig.from_python_module('...config_unet_bigdata')
        pred = Predictor.from_torch_checkpoint('unet_bigdata.pth', cfg)
        depth_mm = pred.predict_depth_from_RGB(diff_images, (320, 427))

    state_dict is the reference-layout U-Net state dict (tensors or numpy
    arrays). device defaults to ``cuda`` and raises when no CUDA device is
    present. Inputs may be numpy arrays or tensors on any device; outputs
    are float32 tensors on the predictor's device.
    """

    def __init__(
        self,
        config: GelslimConfig,
        state_dict,
        *,
        compute_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        self.config = config
        self.unet_cfg = config.unet_config()
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
        self.compute_dtype = compute_dtype
        with torch.device(self.device):
            net = UNet(self.unet_cfg)
        net.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
        self.net = net.to_compute_dtype(compute_dtype)

    @classmethod
    def from_torch_checkpoint(cls, path: str, config: GelslimConfig, **kw) -> "Predictor":
        from gelslim_depth_tpu_torch.models.torch_import import load_torch_checkpoint

        return cls(config, load_torch_checkpoint(path, config.unet_config()), **kw)

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, **kw) -> "Predictor":
        from gelslim_depth_tpu_torch.models.torch_import import params_from_jax
        from gelslim_depth_tpu_torch.train.checkpoint import load_checkpoint

        config, params, stats = load_checkpoint(ckpt_dir)
        return cls(config, params_from_jax(params, stats, config.unet_config()), **kw)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def predict_depth_from_RGB(self, images, output_size: Tuple[int, int]) -> torch.Tensor:
        """(N, 3, H, W) [0,255] images -> (N, 1, *output_size) mm depth."""
        return fused_predict(self.config, self.net, self._tensor(images), tuple(output_size))

    @torch.inference_mode()
    def predict_dual_frames(self, frames, base_frame, output_size: Tuple[int, int]) -> torch.Tensor:
        """(N, 6, H, W) dual frames (+ base) -> (N, 2, *output_size) mm depth."""
        base = None if base_frame is None else self._tensor(base_frame)
        return fused_predict_dual(
            self.config, self.net, self._tensor(frames), base, tuple(output_size)
        )

    def predict_dual_frames_multi(self, frames_list, base_frame, output_size) -> torch.Tensor:
        """Micro-batch entry: a list/tuple of k (1, 6, H, W) frames ->
        (k, 2, *output_size), concatenated into one call."""
        frames = torch.cat([self._tensor(f) for f in frames_list], dim=0)
        return self.predict_dual_frames(frames, base_frame, output_size)

    __call__ = predict_depth_from_RGB


def predict_depth_from_RGB(images, model: Predictor, output_size, config: GelslimConfig = None):
    """Reference-signature convenience wrapper
    (ref complete_prediction.py:4 — with the attribute-name bug fixed)."""
    return model.predict_depth_from_RGB(images, output_size)
