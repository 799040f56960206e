from gelslim_depth_tpu_torch.models.unet import UNet, UNetConfig
from gelslim_depth_tpu_torch.models.torch_import import load_torch_checkpoint, params_from_jax

__all__ = ["UNet", "UNetConfig", "load_torch_checkpoint", "params_from_jax"]
