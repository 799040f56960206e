"""U-Net for tactile depth estimation, eval forward, as a PyTorch module.

The counterpart of ``gelslim_depth_tpu.models.unet.unet_apply(train=False)``.
Submodule and parameter names are the reference's state-dict keys
(``inc.double_conv.{0,1,3,4}``, ``down.{i}.maxpool_conv.1.double_conv.*``,
``up.{i}.up``, ``up.{i}.conv.double_conv.*``, ``outc.conv``), so a reference
``.pth`` loads with ``load_state_dict``.

Reference architecture quirks kept (ref gelslim_depth/models/unet.py):
- DoubleConv = (Conv k=kernel_size, padding hard-coded 1, bias=False ->
  BatchNorm -> activation) x2, padding 1 even for k != 3.
- Down = MaxPool(maxpool_size) + DoubleConv.
- Up = ConvTranspose(in -> in//2, k=kernel_size-1, stride=upconv_stride,
  bias=True), pad to the skip's size (left/top gets diff//2), concat
  [skip, up], DoubleConv. The decoder DoubleConvs are always 3x3.
- OutConv = 1x1 conv with bias.
- The activation knob is honored ('relu' | 'tanh' | 'mish').

Eval BatchNorm folds the running statistics into one affine
``x * inv + (bias - mean * inv)`` with ``inv = rsqrt(var + 1e-5) * scale``.
The fold is computed once, by ``fold_batch_norm``, which construction and
``load_state_dict`` call; the forward only applies it.

Compute dtype (``to_compute_dtype``): float32 runs every conv in full
float32, TF32 off for the forward whatever ``torch.backends.cudnn.allow_tf32``
says, as the JAX package's ``Precision.HIGHEST`` does. bfloat16 follows
``unet_apply(compute_dtype=bfloat16)`` rounding for rounding:
- a conv's output stays bfloat16;
- the BN affine promotes to float32 (bf16 tensor times f32 vector), goes
  through the activation, and is cast back to bfloat16;
- the upconv output gets its bfloat16 bias added in bfloat16;
- the head conv adds its bias in bfloat16, then casts to float32.
Train-mode BatchNorm, rematerialization and sample masks are not ported yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    n_channels: int = 3
    n_classes: int = 1
    layer_dimensions: Tuple[int, ...] = (64, 128, 256, 512, 1024)
    kernel_size: int = 3
    maxpool_size: int = 2
    upconv_stride: int = 2
    activation: str = "relu"

    @property
    def num_levels(self) -> int:
        return len(self.layer_dimensions)


class Activation(nn.Module):
    def __init__(self, name: str):
        super().__init__()
        if name not in ("relu", "tanh", "mish"):
            raise ValueError(f"Unknown activation {name!r}; expected relu|tanh|mish")
        self.name = name

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "relu":
            return F.relu(x)
        if self.name == "tanh":
            return torch.tanh(x)
        return x * torch.tanh(F.softplus(x))


@contextlib.contextmanager
def _no_cudnn_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class DoubleConv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, activation: str):
        super().__init__()
        act = Activation(activation)
        self.double_conv = nn.Sequential(
            nn.Conv2d(cin, cout, k, padding=1, bias=False),
            nn.BatchNorm2d(cout, eps=BN_EPS),
            act,
            nn.Conv2d(cout, cout, k, padding=1, bias=False),
            nn.BatchNorm2d(cout, eps=BN_EPS),
            act,
        )
        self.fold_batch_norm()

    @torch.no_grad()
    def fold_batch_norm(self) -> None:
        """Eval BN i as ``x * bn{i}_scale + bn{i}_shift``, (1, C, 1, 1)
        buffers that the state dict does not hold."""
        for i, bn in enumerate((self.double_conv[1], self.double_conv[4])):
            inv = torch.rsqrt(bn.running_var + BN_EPS) * bn.weight
            shift = bn.bias - bn.running_mean * inv
            self.register_buffer(f"bn{i}_scale", inv.view(1, -1, 1, 1), persistent=False)
            self.register_buffer(f"bn{i}_shift", shift.view(1, -1, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor, dtype: torch.dtype, probe=None) -> torch.Tensor:
        conv1, _, act, conv2, _, _ = self.double_conv
        if probe is not None:
            probe("conv1", x)
        y = F.conv2d(x.to(dtype), conv1.weight, padding=1)
        y = act(y * self.bn0_scale + self.bn0_shift).to(dtype)
        if probe is not None:
            probe("conv2", y)
        y = F.conv2d(y, conv2.weight, padding=1)
        return act(y * self.bn1_scale + self.bn1_shift).to(dtype)


class Down(nn.Module):
    def __init__(self, cin: int, cout: int, cfg: UNetConfig):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            nn.MaxPool2d(cfg.maxpool_size),
            DoubleConv(cin, cout, cfg.kernel_size, cfg.activation),
        )

    def forward(self, x: torch.Tensor, dtype: torch.dtype, probe=None) -> torch.Tensor:
        pool, dc = self.maxpool_conv
        return dc(pool(x), dtype, probe)


class Up(nn.Module):
    def __init__(self, cin: int, cout: int, cfg: UNetConfig):
        super().__init__()
        self.stride = cfg.upconv_stride
        self.up = nn.ConvTranspose2d(cin, cin // 2, cfg.kernel_size - 1, stride=cfg.upconv_stride)
        # the reference's Up never forwards kernel_size to its DoubleConv
        self.conv = DoubleConv(cin, cout, 3, cfg.activation)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, dtype: torch.dtype, probe=None) -> torch.Tensor:
        if probe is not None:
            probe("upconv", x)
        y = F.conv_transpose2d(x.to(dtype), self.up.weight, stride=self.stride)
        y = y + self.up.bias.view(1, -1, 1, 1)
        dy = skip.shape[2] - y.shape[2]
        dx = skip.shape[3] - y.shape[3]
        y = F.pad(y, [dx // 2, dx - dx // 2, dy // 2, dy - dy // 2])
        return self.conv(torch.cat([skip.to(dtype), y], dim=1), dtype, probe)


class OutConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        out = F.conv2d(x.to(dtype), self.conv.weight)
        out = out + self.conv.bias.view(1, -1, 1, 1)
        return out.float()


class UNet(nn.Module):
    """Eval-mode U-Net on NCHW input; returns float32 NCHW logits."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        dims = cfg.layer_dimensions
        self.cfg = cfg
        self.compute_dtype = torch.float32
        self.inc = DoubleConv(cfg.n_channels, dims[0], cfg.kernel_size, cfg.activation)
        self.down = nn.ModuleList(Down(dims[i], dims[i + 1], cfg) for i in range(len(dims) - 1))
        self.up = nn.ModuleList(
            Up(dims[i], dims[i - 1], cfg) for i in range(len(dims) - 1, 0, -1)
        )
        self.outc = OutConv(dims[0], cfg.n_classes)
        self.eval()

    def fold_batch_norm(self) -> None:
        """Recompute every DoubleConv's folded eval BN from its running
        statistics and affine; needed after they change in place."""
        for m in self.modules():
            if isinstance(m, DoubleConv):
                m.fold_batch_norm()

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        out = super().load_state_dict(state_dict, strict=strict, assign=assign)
        self.fold_batch_norm()
        return out

    def to_compute_dtype(self, dtype: torch.dtype) -> "UNet":
        """Run the convs in ``dtype``: their weights and biases are stored in
        it, so the forward casts only activations; BatchNorm stays float32."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.to(dtype)
        self.compute_dtype = dtype
        return self

    def forward(self, x: torch.Tensor, probe=None) -> torch.Tensor:
        """probe(site, h), where given, is called with the input of every
        conv: site is 'inc/conv1', 'down_0/conv2', 'up_1/upconv', ...; the
        int8 calibration records its activation statistics this way."""
        dtype = self.compute_dtype

        def at(block):
            return None if probe is None else lambda conv, h: probe(f"{block}/{conv}", h)

        with _no_cudnn_tf32() if dtype == torch.float32 else contextlib.nullcontext():
            skips = [self.inc(x, dtype, at("inc"))]
            for i, down in enumerate(self.down):
                skips.append(down(skips[-1], dtype, at(f"down_{i}")))
            h = skips[-1]
            for j, up in enumerate(self.up):
                h = up(h, skips[-2 - j], dtype, at(f"up_{j}"))
            return self.outc(h, dtype)
