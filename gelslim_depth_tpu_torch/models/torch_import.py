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
``transpose(2, 3, 1, 0)``. ``jax_path`` and ``state_key`` map one key
to its (block, leaf) and back, so any part of a state (parameters,
statistics, Adam moments, an EMA shadow) crosses with ``to_jax_tree`` /
``from_jax_tree``; ``train_state_from_jax`` carries a whole JAX
``TrainState`` across.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from gelslim_depth_tpu_torch.models.unet import UNet, UNetConfig, unet_state_shapes


_DC_LEAVES = {
    "0.weight": "conv1_w", "1.weight": "bn1_scale", "1.bias": "bn1_bias",
    "1.running_mean": "bn1_mean", "1.running_var": "bn1_var",
    "3.weight": "conv2_w", "4.weight": "bn2_scale", "4.bias": "bn2_bias",
    "4.running_mean": "bn2_mean", "4.running_var": "bn2_var",
}
_DC_KEYS = {leaf: key for key, leaf in _DC_LEAVES.items()}
_KERNELS = ("conv1_w", "conv2_w", "upconv_w", "w")  # HWIO / (kh,kw,out,in) in JAX
_STAT_LEAVES = ("bn1_mean", "bn1_var", "bn2_mean", "bn2_var")


def jax_path(key: str) -> Tuple[str, str]:
    """Reference state-dict key -> (JAX block, leaf): 'inc.double_conv.0.weight'
    -> ('inc', 'conv1_w'), 'up.1.up.bias' -> ('up_1', 'upconv_b')."""
    parts = key.split(".")
    if parts[0] == "inc":
        return "inc", _DC_LEAVES[".".join(parts[2:])]
    if parts[0] == "down":
        return f"down_{parts[1]}", _DC_LEAVES[".".join(parts[5:])]
    if parts[0] == "up" and parts[2] == "up":
        return f"up_{parts[1]}", {"weight": "upconv_w", "bias": "upconv_b"}[parts[3]]
    if parts[0] == "up":
        return f"up_{parts[1]}", _DC_LEAVES[".".join(parts[4:])]
    if parts[0] == "outc":
        return "outc", {"weight": "w", "bias": "b"}[parts[2]]
    raise KeyError(f"{key!r} is not a U-Net state-dict key")


def state_key(block: str, leaf: str) -> str:
    """(JAX block, leaf) -> reference state-dict key; jax_path's inverse."""
    if block == "outc":
        return f"outc.conv.{ {'w': 'weight', 'b': 'bias'}[leaf] }"
    if leaf in ("upconv_w", "upconv_b"):
        return f"up.{block[3:]}.up.{ {'upconv_w': 'weight', 'upconv_b': 'bias'}[leaf] }"
    prefix = {"inc": "inc.double_conv", "down": f"down.{block[5:]}.maxpool_conv.1.double_conv",
              "up": f"up.{block[3:]}.conv.double_conv"}[block.split("_")[0]]
    return f"{prefix}.{_DC_KEYS[leaf]}"


def to_jax_tree(tensors) -> Dict[str, Dict[str, np.ndarray]]:
    """Reference-layout tensors (any subset of a state dict: parameters,
    statistics, Adam moments, an EMA shadow) -> the JAX package's nested
    {block: {leaf: float32 array}}, kernels moved to its layouts."""
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    for key, v in tensors.items():
        if key.endswith("num_batches_tracked"):
            continue
        block, leaf = jax_path(key)
        a = np.array(torch.as_tensor(v).detach().cpu().float().numpy())
        tree.setdefault(block, {})[leaf] = np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if leaf in _KERNELS else a
    return tree


def from_jax_tree(tree) -> Dict[str, torch.Tensor]:
    """to_jax_tree's inverse: {block: {leaf: array}} (numpy-convertible
    leaves) -> reference-layout float32 CPU tensors."""
    out: Dict[str, torch.Tensor] = {}
    for block, leaves in tree.items():
        for leaf, v in leaves.items():
            a = np.array(v, dtype=np.float32)  # a writable copy
            out[state_key(block, leaf)] = torch.from_numpy(
                np.ascontiguousarray(a.transpose(3, 2, 0, 1)) if leaf in _KERNELS else a)
    return out


def check_layout(state_dict, cfg: UNetConfig, source: str) -> None:
    """Raise unless state_dict holds exactly the keys and shapes of UNet(cfg)."""
    want = unet_state_shapes(cfg)
    got = {k: tuple(v.shape) for k, v in state_dict.items() if not k.endswith("num_batches_tracked")}
    if got != want:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        bad = sorted(k for k in set(got) & set(want) if got[k] != want[k])
        raise ValueError(
            f"{source} does not hold a U-Net of {cfg}: missing {missing[:5]}, "
            f"unexpected {extra[:5]}, wrong shapes {bad[:5]}"
        )


def params_from_jax(params, batch_stats, cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """JAX-package ``(params, batch_stats)`` pytrees (numpy-convertible
    leaves) -> reference-layout state dict of float32 CPU tensors."""
    out = {**from_jax_tree(params), **from_jax_tree(batch_stats)}
    check_layout(out, cfg, "the JAX trees")
    return out


def params_to_jax(state_dict, cfg: UNetConfig) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Reference-layout state dict -> the JAX package's ``(params,
    batch_stats)`` pytrees, as nested dicts of float32 numpy arrays."""
    check_layout(state_dict, cfg, "the state dict")
    params, stats = {}, {}
    for block, leaves in to_jax_tree(state_dict).items():
        params[block] = {k: v for k, v in leaves.items() if k not in _STAT_LEAVES}
        if any(k in _STAT_LEAVES for k in leaves):
            stats[block] = {k: v for k, v in leaves.items() if k in _STAT_LEAVES}
    return params, stats


def train_state_from_jax(state, device="cpu"):
    """A JAX-package ``TrainState`` (numpy-convertible leaves) -> the port's
    ``TrainState`` on device: parameters, running statistics, Adam moments
    and count (the ``scale_by_adam`` entry of the optimizer chain), EMA
    shadow, count and decay, and step."""
    from gelslim_depth_tpu_torch.train.ema import EmaState
    from gelslim_depth_tpu_torch.train.steps import AdamState, TrainState

    def tree(t):
        return {k: v.to(device) for k, v in from_jax_tree(t).items()}

    def count(v):
        return torch.tensor(int(np.asarray(v)), dtype=torch.int32, device=device)

    adam = state.opt_state[1]
    return TrainState(
        params=tree(state.params),
        batch_stats=tree(state.batch_stats),
        opt_state=AdamState(count(adam.count), tree(adam.mu), tree(adam.nu)),
        ema=EmaState(tree(state.ema.shadow), count(state.ema.num_updates), float(state.ema.decay)),
        step=count(state.step),
    )


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
    check_layout(sd, cfg, path)
    return sd
