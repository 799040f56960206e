"""The plain reference of the dense-prediction transformer's serving chain:
float32 PyTorch with TF32 off, no kernels, no cache, no fusion, written
from Depth Anything V2's published model
(https://github.com/DepthAnything/Depth-Anything-V2:
``depth_anything_v2/dinov2.py`` and ``depth_anything_v2/dpt.py``) over a
state dict of its layout.

- The chain: the difference image against the base frame, the area
  resize to the network's input, ``mean_std`` normalization, the DPT, the
  depth denormalization and the area resize back to the frame
  (``reference.serving.depth_mm``).
- The encoder, DINOv2 without registers: a stride-patch conv, the class
  token, the position table (held at the input's own patch grid), blocks
  of ``x + ls1 * proj(attn(norm1(x)))`` and ``x + ls2 * fc2(gelu(fc1(
  norm2(x))))``, attention ``softmax(q k^T / sqrt(head dim)) v``, GELU by
  erf; the hooked blocks' outputs through the final norm, the class token
  dropped.
- The head, DPT: 1x1 projections, a transposed conv k4 s4, one k2 s2, an
  identity, a 3x3 s2 conv; the ``layer{i}_rn`` 3x3 convs without bias;
  fusion blocks of residual conv units (ReLU, 3x3, ReLU, 3x3, plus the
  input), a bilinear resize with ``align_corners=True`` and a 1x1 conv;
  the output convs: 3x3 to half the features, the bilinear resize to the
  grid x patch, 3x3, ReLU, 1x1.
- Departures from the published model, the configuration's ``assumed``:
  the ReLU after the last 1x1 conv is left out (the target is the
  normalized depth, which is <= 0), the position table is not resampled.
- ``dtype=torch.bfloat16`` computes the same model as the bfloat16
  program rounds it: weights and each op's output in bfloat16; LayerNorm,
  the LayerScale and residual add, GELU and the softmax in float32 on
  bfloat16 inputs, rounded once; the attention's probabilities rounded to
  bfloat16 for the product with v; the bias and ReLU after a head conv
  that feeds a ReLU in float32, rounded once. Its error against the
  float32 model is the scale the bfloat16 configuration's comparison is
  stated in.
- ``gemm_inputs``, where given, rounds the inputs of the encoder's
  matrix products (qkv, proj, fc1, fc2: the activations and the weights)
  through it before each product: the calibration's control passes a
  per-tensor-scaled float8 rounding.

It imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import serving as ref_serving
from benchmark.reference.unet import no_tf32

FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


def grid(cfg: dict) -> Tuple[int, int]:
    p = cfg["dpt"]["patch_size"]
    h, w = cfg["input_tactile_image_size"]
    return h // p, w // p


def state_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every entry of the published layout's state dict and its shape."""
    d = cfg["dpt"]
    D, p = d["embed_dim"], d["patch_size"]
    hidden, oc, f, hf = d["mlp_ratio"] * D, d["out_channels"], d["features"], d["head_features"]
    gh, gw = grid(cfg)
    s: Dict[str, Tuple[int, ...]] = {
        "pretrained.cls_token": (1, 1, D), "pretrained.pos_embed": (1, 1 + gh * gw, D),
        "pretrained.mask_token": (1, D),
        "pretrained.patch_embed.proj.weight": (D, 3, p, p), "pretrained.patch_embed.proj.bias": (D,),
    }
    for i in range(d["depth"]):
        b = f"pretrained.blocks.{i}"
        for name, shape in (("norm1.weight", (D,)), ("norm1.bias", (D,)),
                            ("attn.qkv.weight", (3 * D, D)), ("attn.qkv.bias", (3 * D,)),
                            ("attn.proj.weight", (D, D)), ("attn.proj.bias", (D,)), ("ls1.gamma", (D,)),
                            ("norm2.weight", (D,)), ("norm2.bias", (D,)),
                            ("mlp.fc1.weight", (hidden, D)), ("mlp.fc1.bias", (hidden,)),
                            ("mlp.fc2.weight", (D, hidden)), ("mlp.fc2.bias", (D,)), ("ls2.gamma", (D,))):
            s[f"{b}.{name}"] = shape
    s["pretrained.norm.weight"] = s["pretrained.norm.bias"] = (D,)
    h = "depth_head"
    for i, c in enumerate(oc):
        s[f"{h}.projects.{i}.weight"], s[f"{h}.projects.{i}.bias"] = (c, D, 1, 1), (c,)
    for i, k in ((0, 4), (1, 2)):
        s[f"{h}.resize_layers.{i}.weight"], s[f"{h}.resize_layers.{i}.bias"] = (oc[i], oc[i], k, k), (oc[i],)
    s[f"{h}.resize_layers.3.weight"], s[f"{h}.resize_layers.3.bias"] = (oc[3], oc[3], 3, 3), (oc[3],)
    for i, c in enumerate(oc, 1):
        s[f"{h}.scratch.layer{i}_rn.weight"] = (f, c, 3, 3)
    for i in range(1, 5):
        r = f"{h}.scratch.refinenet{i}"
        for unit in ("resConfUnit1", "resConfUnit2"):
            for conv in ("conv1", "conv2"):
                s[f"{r}.{unit}.{conv}.weight"], s[f"{r}.{unit}.{conv}.bias"] = (f, f, 3, 3), (f,)
        s[f"{r}.out_conv.weight"], s[f"{r}.out_conv.bias"] = (f, f, 1, 1), (f,)
    s[f"{h}.scratch.output_conv1.weight"], s[f"{h}.scratch.output_conv1.bias"] = (f // 2, f, 3, 3), (f // 2,)
    s[f"{h}.scratch.output_conv2.0.weight"], s[f"{h}.scratch.output_conv2.0.bias"] = (hf, f // 2, 3, 3), (hf,)
    s[f"{h}.scratch.output_conv2.2.weight"], s[f"{h}.scratch.output_conv2.2.bias"] = (1, hf, 1, 1), (1,)
    return s


def fp8_rounding(t: torch.Tensor) -> torch.Tensor:
    """t through float8_e4m3fn at a per-tensor scale (its largest
    magnitude at float8's largest value), back in t's dtype."""
    s = t.abs().amax().float().clamp(min=1e-30) / FP8_MAX
    return ((t.float() / s).to(torch.float8_e4m3fn).float() * s).to(t.dtype)


def forward(cfg: dict, sd: Dict[str, torch.Tensor], x: torch.Tensor, *, dtype: torch.dtype = torch.float32,
            gemm_inputs: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """(N, 3, H, W) float32 images -> (N, 1, H, W) float32 logits, in eval
    mode, in ``dtype`` as the module's docstring says."""
    d = cfg["dpt"]
    D, p, heads, eps = d["embed_dim"], d["patch_size"], d["num_heads"], d["layer_norm_eps"]
    dh = D // heads
    gh, gw = grid(cfg)
    n = x.shape[0]

    def w(key):  # a weight as the program holds it
        return sd[key].to(dtype)

    def f32(t):
        return t.float()

    def layer_norm(t, prefix):
        return F.layer_norm(f32(t), (D,), f32(w(f"{prefix}.weight")), f32(w(f"{prefix}.bias")), eps).to(dtype)

    def linear(t, prefix):
        weight = w(f"{prefix}.weight")
        if gemm_inputs is not None:
            t, weight = gemm_inputs(t), gemm_inputs(weight)
        return F.linear(t, weight, w(f"{prefix}.bias"))

    def scaled_add(t, y, key):  # t + gamma * y, rounded once
        return (f32(t) + f32(y) * f32(w(key))).to(dtype)

    def gelu(t):
        t = f32(t)
        return (0.5 * t * (1.0 + torch.erf(t / math.sqrt(2.0)))).to(dtype)

    def attention(qkv):
        q, k, v = qkv.reshape(n, -1, 3, heads, dh).permute(2, 0, 3, 1, 4)
        probs = torch.softmax(f32(q) @ f32(k).transpose(-1, -2) / math.sqrt(dh), dim=-1)
        return (probs.to(dtype) @ v).transpose(1, 2).reshape(n, -1, D)

    # encoder
    pe = "pretrained.patch_embed.proj"
    t = F.conv2d(x.to(dtype), w(f"{pe}.weight"), w(f"{pe}.bias"), stride=p).flatten(2).transpose(1, 2)
    t = torch.cat([w("pretrained.cls_token").expand(n, -1, -1), t], dim=1) + w("pretrained.pos_embed")
    hooks = []
    for i in range(d["depth"]):
        b = f"pretrained.blocks.{i}"
        t = scaled_add(t, linear(attention(linear(layer_norm(t, f"{b}.norm1"), f"{b}.attn.qkv")),
                                 f"{b}.attn.proj"), f"{b}.ls1.gamma")
        t = scaled_add(t, linear(gelu(linear(layer_norm(t, f"{b}.norm2"), f"{b}.mlp.fc1")), f"{b}.mlp.fc2"),
                       f"{b}.ls2.gamma")
        if i in d["hooks"]:
            hooks.append(layer_norm(t, "pretrained.norm")[:, 1:])

    # head
    h = "depth_head"
    s = f"{h}.scratch"

    def conv(t, key, bias=True, **kw):
        return F.conv2d(t, w(f"{key}.weight"), w(f"{key}.bias") if bias else None, **kw)

    def bias_relu(t, key):  # relu(conv + bias) in float32, rounded once
        return torch.relu(f32(t) + f32(w(f"{key}.bias")).view(1, -1, 1, 1)).to(dtype)

    def unit(t, key):
        y = bias_relu(conv(torch.relu(t), f"{key}.conv1", bias=False, padding=1), f"{key}.conv1")
        return conv(y, f"{key}.conv2", padding=1) + t

    def fusion(i, t, skip, size):
        r = f"{s}.refinenet{i}"
        if skip is not None:
            t = t + unit(skip, f"{r}.resConfUnit1")
        t = F.interpolate(unit(t, f"{r}.resConfUnit2"), size=size, mode="bilinear", align_corners=True)
        return conv(t, f"{r}.out_conv")

    layers = []
    for i, t in enumerate(hooks):
        y = conv(t.transpose(1, 2).reshape(n, D, gh, gw), f"{h}.projects.{i}")
        if i < 2:
            key = f"{h}.resize_layers.{i}"
            y = F.conv_transpose2d(y, w(f"{key}.weight"), w(f"{key}.bias"), stride=4 // (i + 1))
        elif i == 3:
            y = conv(y, f"{h}.resize_layers.3", stride=2, padding=1)
        layers.append(conv(y, f"{s}.layer{i + 1}_rn", bias=False, padding=1))
    l1, l2, l3, l4 = layers
    path = fusion(4, l4, None, l3.shape[2:])
    path = fusion(3, path, l3, l2.shape[2:])
    path = fusion(2, path, l2, l1.shape[2:])
    path = fusion(1, path, l1, (2 * l1.shape[2], 2 * l1.shape[3]))
    y = F.interpolate(conv(path, f"{s}.output_conv1", padding=1), size=(gh * p, gw * p), mode="bilinear",
                      align_corners=True)
    y = bias_relu(conv(y, f"{s}.output_conv2.0", bias=False, padding=1), f"{s}.output_conv2.0")
    return f32(conv(y, f"{s}.output_conv2.2"))


def network_input(cfg: dict, frames: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """(n, 6, H, W) dual frames and a (6, H, W) base in [0, 255] -> the
    (2n, 3, h, w) input, the left fingers' rows first: the difference
    image, the area resize, ``(x - mean) / std`` per channel."""
    n, _, fh, fw = frames.shape
    fingers = frames.reshape(n, 2, 3, fh, fw)
    if cfg["use_difference_image"]:
        fingers = (fingers - base.reshape(1, 2, 3, fh, fw) + 255.0) / 2.0
    fingers = fingers.transpose(0, 1).reshape(2 * n, 3, fh, fw)
    if cfg["interp_method"] != "area" or cfg["image_normalization_method"] != "mean_std":
        raise ValueError("the DPT reference resizes by area and normalizes by mean_std only")
    x = F.interpolate(fingers, size=tuple(cfg["input_tactile_image_size"]), mode="area")
    _, _, mean, std = cfg["image_normalization_parameters"]
    mean, std = (torch.tensor(v, dtype=torch.float32, device=x.device).view(1, 3, 1, 1) for v in (mean, std))
    return (x - mean) / std


@torch.no_grad()
def predict(cfg: dict, sd, frames: torch.Tensor, base: torch.Tensor, *, dtype: torch.dtype = torch.float32,
            gemm_inputs=None) -> torch.Tensor:
    """(n, 6, H, W) dual frames -> (n, 2, H, W) depth in mm; the DPT in
    dtype (``forward``), the rest in float32."""
    with no_tf32():
        y = forward(cfg, sd, network_input(cfg, frames, base), dtype=dtype, gemm_inputs=gemm_inputs)
        return ref_serving.depth_mm(cfg, y, frames.shape[0])
