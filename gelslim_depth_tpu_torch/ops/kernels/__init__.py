"""Hand-written CUDA kernels of the port, each beside its plain PyTorch twin.

- preprocess_kernel.fused_preprocess_dual  (replaces the Pallas kernel
  gelslim_depth_tpu/ops/pallas/preprocess_kernel.py:_kernel)
"""

from gelslim_depth_tpu_torch.ops.kernels.preprocess_kernel import (
    fused_preprocess_dual,
    fused_preprocess_dual_reference,
)

__all__ = ["fused_preprocess_dual", "fused_preprocess_dual_reference"]
