"""Weights into and out of the port's U-Net: reference ``.pth`` files, the
JAX package's parameter pytrees, and its quantized models.

The reference state dict (ref unet.py module tree) is the port's native
layout:

    inc.double_conv.{0,3}.weight                conv kernels, OIHW
    inc.double_conv.{1,4}.{weight,bias,running_mean,running_var}
    down.{i}.maxpool_conv.1.double_conv.{0,1,3,4}.*
    up.{i}.up.{weight,bias}                     convtranspose, (in,out,kh,kw)
    up.{i}.conv.double_conv.{0,1,3,4}.*
    outc.conv.{weight,bias}

The JAX package keeps HWIO conv kernels and (kh,kw,out,in) upconv kernels;
both come back with ``transpose(3, 2, 0, 1)`` and go there with
``transpose(2, 3, 1, 0)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

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


def params_to_jax(state_dict, cfg: UNetConfig) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Reference-layout state dict -> the JAX package's ``(params,
    batch_stats)`` pytrees, as nested dicts of float32 numpy arrays."""

    def get(key, transpose=False):
        a = np.array(torch.as_tensor(state_dict[key]).detach().cpu().float().numpy())
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if transpose else a

    def dc(prefix):
        p = {"conv1_w": get(f"{prefix}.0.weight", True), "bn1_scale": get(f"{prefix}.1.weight"),
             "bn1_bias": get(f"{prefix}.1.bias"), "conv2_w": get(f"{prefix}.3.weight", True),
             "bn2_scale": get(f"{prefix}.4.weight"), "bn2_bias": get(f"{prefix}.4.bias")}
        s = {"bn1_mean": get(f"{prefix}.1.running_mean"), "bn1_var": get(f"{prefix}.1.running_var"),
             "bn2_mean": get(f"{prefix}.4.running_mean"), "bn2_var": get(f"{prefix}.4.running_var")}
        return p, s

    params, stats = {}, {}
    params["inc"], stats["inc"] = dc("inc.double_conv")
    for i in range(cfg.num_levels - 1):
        params[f"down_{i}"], stats[f"down_{i}"] = dc(f"down.{i}.maxpool_conv.1.double_conv")
        p, stats[f"up_{i}"] = dc(f"up.{i}.conv.double_conv")
        params[f"up_{i}"] = {"upconv_w": get(f"up.{i}.up.weight", True), "upconv_b": get(f"up.{i}.up.bias"), **p}
    params["outc"] = {"w": get("outc.conv.weight", True), "b": get("outc.conv.bias")}
    return params, stats


def quantized_from_jax(q):
    """A JAX-package ``QuantizedUNet`` (leaves numpy-convertible) -> the
    port's ``QuantizedUNet`` on the CPU: the same float parameters, int8
    weights, weight scales, activation scales and float_delta, with the int8
    weights moved from HWIO and the ``(s, cin, s*cout)`` row-split pack to the
    port's layouts."""
    from gelslim_depth_tpu_torch.models.quantize import QuantizedUNet, ohwi_from_hwio, rowsplit_from_jax

    cfg = UNetConfig(**{f.name: getattr(q.cfg, f.name) for f in dataclasses.fields(UNetConfig)})
    net = UNet(cfg)
    net.load_state_dict(params_from_jax(q.params, q.batch_stats, cfg))
    w8, w_scale = {}, {}
    for block, convs in q.w8.items():
        for conv, arr in convs.items():
            t = torch.from_numpy(np.array(arr, dtype=np.int8))
            w8[f"{block}/{conv}"] = rowsplit_from_jax(t) if conv == "upconv" else ohwi_from_hwio(t)
            w_scale[f"{block}/{conv}"] = torch.from_numpy(np.array(q.w_scale[block][conv], dtype=np.float32))
    act_scale = {k: float(np.float32(v)) for k, v in q.act_scale.items()}
    return QuantizedUNet(net, w8, w_scale, act_scale, float(np.asarray(q.float_delta)))


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
