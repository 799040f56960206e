"""Stateless tensor ops of the PyTorch port, on CHW / NCHW tensors (channel
at axis -3), mirroring ``gelslim_depth_tpu.ops``:

- image.get_difference_image          (ref: processing_utils/image_utils.py:6)
- image.gaussian_blur / blur_depth_images
                                      (ref: processing_utils/image_utils.py:17)
- resize.area_resize / resize.resize  (ref: processing_utils/image_utils.py:12)
- normalize.normalize_tactile_image / denormalize_tactile_image
                                      (ref: processing_utils/normalization_utils.py:4,37)
- normalize.normalize_depth_image / denormalize_depth_image
                                      (ref: processing_utils/normalization_utils.py:70,101)

The hand-written CUDA kernels live in ``ops.kernels``.
"""

from gelslim_depth_tpu_torch.ops.image import blur_depth_images, gaussian_blur, get_difference_image
from gelslim_depth_tpu_torch.ops.resize import area_resize, resize
from gelslim_depth_tpu_torch.ops.normalize import (
    normalize_tactile_image,
    denormalize_tactile_image,
    normalize_depth_image,
    denormalize_depth_image,
    image_norm_coeffs,
    depth_norm_coeffs,
)

__all__ = [
    "get_difference_image",
    "gaussian_blur",
    "blur_depth_images",
    "area_resize",
    "resize",
    "normalize_tactile_image",
    "denormalize_tactile_image",
    "normalize_depth_image",
    "denormalize_depth_image",
    "image_norm_coeffs",
    "depth_norm_coeffs",
]
