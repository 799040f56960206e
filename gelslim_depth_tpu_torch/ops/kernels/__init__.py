"""Hand-written CUDA kernels of the port, each beside its plain PyTorch twin.

- preprocess_kernel.fused_preprocess_dual  (replaces the Pallas kernel
  gelslim_depth_tpu/ops/pallas/preprocess_kernel.py:_kernel)
- conv_int8.conv2d_int8  (replaces XLA's s8 x s8 -> s32 convolution and dot
  of gelslim_depth_tpu/models/quantize.py:164 and :136)
- conv_epilogue.conv_epilogue  (replaces the elementwise passes XLA fuses
  into the float convs' epilogues: gelslim_depth_tpu/models/unet.py:197,
  :229 and :275, quantize.py:156; and, with no TPU counterpart, the
  transformers' heads' conv bias adds and residual units' skip adds; its
  destination form also the bf16 U-Net's pads and concats); the
  module shares the function's name, so it is imported from the module,
  not from here
- bilinear_resize.bilinear_resize  (replaces no TPU kernel: the DPT head's
  bilinear resizes with align_corners=True, in place of aten's; imported
  from its module, as conv_epilogue is)
- residual_layer_norm.residual_layer_norm  (replaces no TPU kernel: the ViT
  encoder's LayerScale residual add with the LayerNorm after it, in place
  of aten's addcmul and LayerNorm; imported from its module)
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
