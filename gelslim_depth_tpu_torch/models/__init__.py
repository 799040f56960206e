from gelslim_depth_tpu_torch.models.unet import UNet, UNetConfig
from gelslim_depth_tpu_torch.models.torch_import import (
    load_torch_checkpoint,
    params_from_jax,
    params_to_jax,
    quantized_from_jax,
)
from gelslim_depth_tpu_torch.models.quantize import QuantizedUNet, quantize_unet, unet_apply_int8

__all__ = [
    "QuantizedUNet",
    "UNet",
    "UNetConfig",
    "load_torch_checkpoint",
    "params_from_jax",
    "params_to_jax",
    "quantize_unet",
    "quantized_from_jax",
    "unet_apply_int8",
]
