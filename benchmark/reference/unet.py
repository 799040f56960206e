"""The plain reference U-Net: float32 PyTorch with TF32 off, no kernels, no
cache, no fusion, written from the published architecture
(gelslim_depth/models/unet.py of https://github.com/MMintLab/gelslim_depth)
over a reference-layout state dict.

- DoubleConv: (conv k x k, padding 1, no bias -> BatchNorm -> activation)
  twice; Down: max-pool, DoubleConv; Up: transposed conv (in -> in // 2,
  kernel k - 1, the upconv stride, with bias), zero-pad to the skip's size
  (top and left get half, rounded down), concat [skip, up], a 3x3
  DoubleConv; the head a 1x1 conv with bias.
- BatchNorm in eval mode: the running statistics, then the affine.
- ``quant`` fake-quantizes the input and weight of each quantized conv
  (the int8 scheme's sites, ``quant_sites``) in float32: int8 for the
  int8 configuration, int4 for its control.
- ``dtype=torch.bfloat16`` computes the same model in bfloat16: the scale
  of a bfloat16 program's own rounding error, which the bfloat16
  configuration's comparison is stated in.

It imports nothing of the program under test.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5


@contextlib.contextmanager
def no_tf32():
    """float32 convs and matmuls in float32, whatever the global flags."""
    keep = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = keep


def dims_of(cfg: dict) -> List[int]:
    return list(cfg["CNN_dimensions"])


def state_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every entry of the reference-layout state dict and its shape."""
    dims, k, cin0, ncls = dims_of(cfg), cfg["kernel_size"], cfg["n_channels"], cfg["n_classes"]
    shapes: Dict[str, Tuple[int, ...]] = {}

    def dc(prefix, cin, cout, kk):
        for conv, bn, c in ((0, 1, cin), (3, 4, cout)):
            shapes[f"{prefix}.{conv}.weight"] = (cout, c, kk, kk)
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                shapes[f"{prefix}.{bn}.{leaf}"] = (cout,)

    dc("inc.double_conv", cin0, dims[0], k)
    for i in range(len(dims) - 1):
        dc(f"down.{i}.maxpool_conv.1.double_conv", dims[i], dims[i + 1], k)
    for j in range(len(dims) - 1):
        cin, cout = dims[-1 - j], dims[-2 - j]
        shapes[f"up.{j}.up.weight"] = (cin, cin // 2, k - 1, k - 1)
        shapes[f"up.{j}.up.bias"] = (cin // 2,)
        dc(f"up.{j}.conv.double_conv", cin, cout, 3)
    shapes["outc.conv.weight"] = (ncls, dims[0], 1, 1)
    shapes["outc.conv.bias"] = (ncls,)
    return shapes


def quant_sites(cfg: dict) -> List[str]:
    """The int8 scheme's quantized convs: both convs of every DoubleConv
    but the first one's."""
    L = len(dims_of(cfg))
    sites = ["inc/conv2"]
    for i in range(L - 1):
        sites += [f"down_{i}/conv1", f"down_{i}/conv2"]
    for j in range(L - 1):
        sites += [f"up_{j}/conv1", f"up_{j}/conv2"]
    return sites


def fake_quant(x: torch.Tensor, scale, levels: int) -> torch.Tensor:
    """Symmetric quantization to +-levels steps of scale, back in float32
    (scale a scalar, or per output channel for a weight)."""
    return torch.clamp(torch.round(x / scale), -levels, levels) * scale


class Quant:
    """Symmetric fake quantization at the quantized sites: static
    per-tensor activation scales ``max|x| / levels`` from a calibration
    forward (``calibrate``), per-output-channel weight scales
    ``max|w[o]| / levels`` (1 where that is 0). levels 127 is int8, 7 is
    int4."""

    def __init__(self, levels: int, act_scale: Dict[str, float]):
        self.levels, self.act_scale = levels, act_scale

    def act(self, site: str, x: torch.Tensor) -> torch.Tensor:
        return fake_quant(x, self.act_scale[site], self.levels)

    def weight(self, site: str, w: torch.Tensor) -> torch.Tensor:
        s = w.abs().amax(dim=(1, 2, 3), keepdim=True) / self.levels
        return fake_quant(w, torch.where(s == 0, torch.ones_like(s), s), self.levels)


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name != "relu":
        raise ValueError(f"the reference has no activation {name!r}")
    return torch.relu


def _bn(y, sd, prefix):
    """Eval BatchNorm: the running statistics, then the affine."""
    mean, var = sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"]
    return (y - mean.view(1, -1, 1, 1)) / torch.sqrt(var.view(1, -1, 1, 1) + BN_EPS) \
        * sd[f"{prefix}.weight"].view(1, -1, 1, 1) + sd[f"{prefix}.bias"].view(1, -1, 1, 1)


def forward(cfg: dict, sd: Dict[str, torch.Tensor], x: torch.Tensor, *, quant=None,
            probe: Optional[Callable[[str, torch.Tensor], None]] = None,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """NCHW float32 images -> NCHW float32 logits, in eval mode. probe(site,
    x) sees the input of every quantized site; quant (a ``Quant``)
    fake-quantizes those sites. dtype bfloat16 computes the same model as
    a plain bfloat16 program rounds it: each conv's input, weight and
    output in bfloat16, the BatchNorm and activation in float32 on that
    output and rounded back, the upconv's bias added in bfloat16, the head
    in bfloat16 with its bias, then float32."""
    act = activation(cfg.get("activation_func", "relu"))
    pool, stride = cfg["maxpool_size"], cfg["upconv_stride"]
    qsites = set(quant_sites(cfg))

    def conv(site, h, w):
        if site in qsites:
            if probe is not None:
                probe(site, h)
            if quant is not None:
                h, w = quant.act(site, h), quant.weight(site, w)
        return F.conv2d(h.to(dtype), w.to(dtype), padding=1)

    def double_conv(block, prefix, h):
        h = act(_bn(conv(f"{block}/conv1", h, sd[f"{prefix}.0.weight"]), sd, f"{prefix}.1")).to(dtype)
        return act(_bn(conv(f"{block}/conv2", h, sd[f"{prefix}.3.weight"]), sd, f"{prefix}.4")).to(dtype)

    L = len(dims_of(cfg))
    with no_tf32():
        skips = [double_conv("inc", "inc.double_conv", x)]
        for i in range(L - 1):
            skips.append(double_conv(f"down_{i}", f"down.{i}.maxpool_conv.1.double_conv",
                                     F.max_pool2d(skips[-1], pool)))
        h = skips[-1]
        for j in range(L - 1):
            skip = skips[-2 - j]
            y = F.conv_transpose2d(h, sd[f"up.{j}.up.weight"].to(dtype), stride=stride)
            y = y + sd[f"up.{j}.up.bias"].to(dtype).view(1, -1, 1, 1)
            dy, dx = skip.shape[2] - y.shape[2], skip.shape[3] - y.shape[3]
            y = F.pad(y, [dx // 2, dx - dx // 2, dy // 2, dy - dy // 2])
            h = double_conv(f"up_{j}", f"up.{j}.conv.double_conv", torch.cat([skip, y], dim=1))
        out = F.conv2d(h, sd["outc.conv.weight"].to(dtype)) + sd["outc.conv.bias"].to(dtype).view(1, -1, 1, 1)
        return out.float()


def calibrate(cfg: dict, sd, x: torch.Tensor, levels: int) -> Quant:
    """A ``Quant`` whose activation scales come from a float32 eval
    forward over the calibration images x."""
    amax: Dict[str, torch.Tensor] = {}

    def probe(site, h):
        amax[site] = h.abs().amax()

    with torch.no_grad():
        forward(cfg, sd, x, probe=probe)
    return Quant(levels, {s: float(np.float32(float(v) / levels)) if float(v) > 0 else 1.0 for s, v in amax.items()})
