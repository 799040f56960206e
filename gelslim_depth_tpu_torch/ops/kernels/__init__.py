"""Hand-written CUDA kernels of the port, each beside its plain PyTorch twin.

- preprocess_kernel.fused_preprocess_dual  (replaces the Pallas kernel
  gelslim_depth_tpu/ops/pallas/preprocess_kernel.py:_kernel)
- conv_int8.conv2d_int8  (replaces XLA's s8 x s8 -> s32 convolution and dot
  of gelslim_depth_tpu/models/quantize.py:164 and :136)
"""

from gelslim_depth_tpu_torch.ops.kernels.conv_int8 import (
    Epilogue,
    conv2d_int8,
    conv2d_int8_reference,
)
from gelslim_depth_tpu_torch.ops.kernels.preprocess_kernel import (
    fused_preprocess_dual,
    fused_preprocess_dual_reference,
)

__all__ = [
    "Epilogue",
    "conv2d_int8",
    "conv2d_int8_reference",
    "fused_preprocess_dual",
    "fused_preprocess_dual_reference",
]
