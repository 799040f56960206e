from gelslim_depth_tpu_torch.models.dpt import DPT, DPTConfig, dpt_state_shapes
from gelslim_depth_tpu_torch.models.unet import UNet, UNetConfig, init_unet, reinit_weights_normal, unet_apply
from gelslim_depth_tpu_torch.models.torch_import import (
    load_torch_checkpoint,
    params_from_jax,
    params_to_jax,
    quantized_from_jax,
    train_state_from_jax,
)
from gelslim_depth_tpu_torch.models.quantize import QuantizedUNet, quantize_unet, unet_apply_int8

__all__ = [
    "DPT",
    "DPTConfig",
    "dpt_state_shapes",
    "QuantizedUNet",
    "UNet",
    "UNetConfig",
    "load_torch_checkpoint",
    "params_from_jax",
    "params_to_jax",
    "quantize_unet",
    "quantized_from_jax",
    "train_state_from_jax",
    "unet_apply",
    "unet_apply_int8",
    "init_unet",
    "reinit_weights_normal",
]
