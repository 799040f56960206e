"""Weights into the port's U-Net: reference ``.pth`` files and the JAX
package's parameter pytrees.

The reference state dict (ref unet.py module tree) is the port's native
layout:

    inc.double_conv.{0,3}.weight                conv kernels, OIHW
    inc.double_conv.{1,4}.{weight,bias,running_mean,running_var}
    down.{i}.maxpool_conv.1.double_conv.{0,1,3,4}.*
    up.{i}.up.{weight,bias}                     convtranspose, (in,out,kh,kw)
    up.{i}.conv.double_conv.{0,1,3,4}.*
    outc.conv.{weight,bias}

The JAX package keeps HWIO conv kernels and (kh,kw,out,in) upconv kernels;
both come back with ``transpose(3, 2, 0, 1)``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from gelslim_depth_tpu_torch.models.unet import UNet, UNetConfig


def params_from_jax(params, batch_stats, cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """JAX-package ``(params, batch_stats)`` pytrees (numpy-convertible
    leaves) -> reference-layout state dict of float32 CPU tensors."""
    out: Dict[str, torch.Tensor] = {}

    def put(key, v, transpose=False):
        a = np.array(v, dtype=np.float32)  # a writable copy
        out[key] = torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)) if transpose else a)

    def put_dc(prefix, p, s):
        put(f"{prefix}.0.weight", p["conv1_w"], transpose=True)
        put(f"{prefix}.1.weight", p["bn1_scale"])
        put(f"{prefix}.1.bias", p["bn1_bias"])
        put(f"{prefix}.1.running_mean", s["bn1_mean"])
        put(f"{prefix}.1.running_var", s["bn1_var"])
        put(f"{prefix}.3.weight", p["conv2_w"], transpose=True)
        put(f"{prefix}.4.weight", p["bn2_scale"])
        put(f"{prefix}.4.bias", p["bn2_bias"])
        put(f"{prefix}.4.running_mean", s["bn2_mean"])
        put(f"{prefix}.4.running_var", s["bn2_var"])

    put_dc("inc.double_conv", params["inc"], batch_stats["inc"])
    for i in range(cfg.num_levels - 1):
        put_dc(f"down.{i}.maxpool_conv.1.double_conv", params[f"down_{i}"], batch_stats[f"down_{i}"])
        put_dc(f"up.{i}.conv.double_conv", params[f"up_{i}"], batch_stats[f"up_{i}"])
        put(f"up.{i}.up.weight", params[f"up_{i}"]["upconv_w"], transpose=True)
        put(f"up.{i}.up.bias", params[f"up_{i}"]["upconv_b"])
    put("outc.conv.weight", params["outc"]["w"], transpose=True)
    put("outc.conv.bias", params["outc"]["b"])
    return out


def load_torch_checkpoint(path: str, cfg: UNetConfig) -> Dict[str, Any]:
    """Load a reference ``.pth`` state dict onto the CPU and check that its
    keys and shapes are those of ``UNet(cfg)``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in UNet(cfg).state_dict().items()
                if not k.endswith("num_batches_tracked")}
    got = {k: tuple(v.shape) for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    if got != want:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        bad = sorted(k for k in set(got) & set(want) if got[k] != want[k])
        raise ValueError(
            f"{path} does not hold a U-Net of {cfg}: missing {missing[:5]}, "
            f"unexpected {extra[:5]}, wrong shapes {bad[:5]}"
        )
    return sd
