"""The plain reference of Depth Pro's serving chain: float32 PyTorch with
TF32 off, no kernels, no cache, no fusion, written from Apple's published
model (https://github.com/apple/ml-depth-pro: ``src/depth_pro/depth_pro.py``,
``network/encoder.py``, ``network/decoder.py``, ``network/vit_factory.py``,
preset ``dinov2l16_384``) over a state dict of the program's layout
(``state_shapes``: the published names, but each encoder's DINOv2
``mask_token`` and the fusion blocks' residual units named as the DPT's).

- The chain: the difference image against the base frame, the published
  ``infer``'s bilinear resize (``align_corners=False``, no antialias) to
  the network's square input, ``mean_std`` normalization (the published
  ``Normalize(0.5, 0.5)`` is 127.5 and 127.5 in pixel units), the network,
  the depth denormalization and the area resize back to the frame
  (``reference.serving.depth_mm``). ``predict`` runs it one dual frame at
  a time.
- The network: the pyramid (``F.interpolate`` by 0.5 and 0.25, bilinear,
  ``align_corners=False``); the split into 5 x 5 tiles at overlap 0.25, 3 x
  3 at 0.5, and the quarter-size image, batched tile-major; the patch
  encoder on every tile, its final normed tokens and the raw outputs of
  its hooked blocks on the full-size tiles; the merges, each tile cropped
  by the configuration's padding on its inner sides; the image encoder on
  the quarter-size image; the projection-upsample blocks (a 1x1 conv, then
  transposed convs k2 s2), ``upsample_lowres`` and ``fuse_lowres``; the
  multi-resolution decoder (3x3 convs into the decoder's width, fusion
  blocks of residual conv units, a transposed conv k2 s2 at levels 1-4, a
  1x1 conv); the head (3x3, transposed conv k2 s2, 3x3, ReLU, 1x1).
- The encoders, DINOv2 ViT-L/16 (timm's ``forward_features``): a
  stride-patch conv, the class token, the position table, blocks of ``x +
  ls1 * proj(attn(norm1(x)))`` and ``x + ls2 * fc2(gelu(fc1(norm2(x))))``,
  attention ``softmax(q k^T / sqrt(head dim)) v``, GELU by erf, the final
  norm.
- Departures from the published model, the configuration's ``assumed``
  and ``reduced``: no FOV network, no ReLU after the head's last 1x1 conv,
  the canonical inverse depth read as the normalized depth.
- ``dtype=torch.bfloat16`` computes the same model as the bfloat16
  program rounds it, as ``reference/dpt.py`` states it; besides, the
  pyramid in float32, each level rounded once. ``gemm_inputs`` rounds the
  inputs of both encoders' matrix products, as ``reference/dpt.py``'s
  does.

It imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import serving as ref_serving
from benchmark.reference.unet import no_tf32

SPLITS = ((5, 0.25), (3, 0.5))  # (tiles a side, overlap) of x's split and x1's
ENCODERS = ("encoder.patch_encoder", "encoder.image_encoder")


def tile(cfg: dict) -> int:
    """The encoders' tile side: a quarter of the square input's."""
    return cfg["input_tactile_image_size"][0] // 4


def grid(cfg: dict) -> int:
    return tile(cfg) // cfg["depth_pro"]["patch_size"]


def _upsample_shapes(prefix: str, dim_in: int, dim_out: int, layers: int, dim_int: Optional[int] = None):
    dim_int = dim_out if dim_int is None else dim_int
    s = {f"{prefix}.0.weight": (dim_int, dim_in, 1, 1)}
    for i in range(layers):
        s[f"{prefix}.{i + 1}.weight"] = (dim_int if i == 0 else dim_out, dim_out, 2, 2)
    return s


def state_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every entry of the state dict and its shape."""
    d = cfg["depth_pro"]
    D, p, hidden = d["embed_dim"], d["patch_size"], d["mlp_ratio"] * d["embed_dim"]
    dims, f, hf = d["dims_encoder"], d["decoder_features"], d["head_features"]
    g = grid(cfg)
    s: Dict[str, Tuple[int, ...]] = {}
    for e in ENCODERS:
        s.update({f"{e}.cls_token": (1, 1, D), f"{e}.pos_embed": (1, 1 + g * g, D), f"{e}.mask_token": (1, D),
                  f"{e}.patch_embed.proj.weight": (D, 3, p, p), f"{e}.patch_embed.proj.bias": (D,)})
        for i in range(d["depth"]):
            b = f"{e}.blocks.{i}"
            for name, shape in (("norm1.weight", (D,)), ("norm1.bias", (D,)),
                                ("attn.qkv.weight", (3 * D, D)), ("attn.qkv.bias", (3 * D,)),
                                ("attn.proj.weight", (D, D)), ("attn.proj.bias", (D,)), ("ls1.gamma", (D,)),
                                ("norm2.weight", (D,)), ("norm2.bias", (D,)),
                                ("mlp.fc1.weight", (hidden, D)), ("mlp.fc1.bias", (hidden,)),
                                ("mlp.fc2.weight", (D, hidden)), ("mlp.fc2.bias", (D,)), ("ls2.gamma", (D,))):
                s[f"{b}.{name}"] = shape
        s[f"{e}.norm.weight"] = s[f"{e}.norm.bias"] = (D,)
    s.update(_upsample_shapes("encoder.upsample_latent0", D, f, 3, dim_int=dims[0]))
    s.update(_upsample_shapes("encoder.upsample_latent1", D, dims[0], 2))
    for i in range(3):
        s.update(_upsample_shapes(f"encoder.upsample{i}", D, dims[i + 1], 1))
    s["encoder.upsample_lowres.weight"], s["encoder.upsample_lowres.bias"] = (D, dims[3], 2, 2), (dims[3],)
    s["encoder.fuse_lowres.weight"], s["encoder.fuse_lowres.bias"] = (dims[3], 2 * dims[3], 1, 1), (dims[3],)
    levels = (f,) + tuple(dims)
    for i, c in enumerate(levels):
        if i:
            s[f"decoder.convs.{i}.weight"] = (f, c, 3, 3)
        r = f"decoder.fusions.{i}"
        for unit in ("resConfUnit1", "resConfUnit2"):
            for conv in ("conv1", "conv2"):
                s[f"{r}.{unit}.{conv}.weight"], s[f"{r}.{unit}.{conv}.bias"] = (f, f, 3, 3), (f,)
        if i:
            s[f"{r}.deconv.weight"] = (f, f, 2, 2)
        s[f"{r}.out_conv.weight"], s[f"{r}.out_conv.bias"] = (f, f, 1, 1), (f,)
    s["head.0.weight"], s["head.0.bias"] = (f // 2, f, 3, 3), (f // 2,)
    s["head.1.weight"], s["head.1.bias"] = (f // 2, f // 2, 2, 2), (f // 2,)
    s["head.2.weight"], s["head.2.bias"] = (hf, f // 2, 3, 3), (hf,)
    s["head.4.weight"], s["head.4.bias"] = (1, hf, 1, 1), (1,)
    return s


def split(x: torch.Tensor, t: int, overlap: float) -> torch.Tensor:
    """The published ``split``: x's tiles of side t, row-major, batched
    tile-major."""
    size = x.shape[-1]
    stride = int(t * (1 - overlap))
    steps = int(math.ceil((size - t) / stride)) + 1
    return torch.cat([x[..., j * stride:j * stride + t, i * stride:i * stride + t]
                      for j in range(steps) for i in range(steps)], dim=0)


def merge(x: torch.Tensor, n: int, padding: int) -> torch.Tensor:
    """The published ``merge`` of (steps^2 n, C, g, g) tile maps."""
    steps = int(math.sqrt(x.shape[0] // n))
    rows, idx = [], 0
    for j in range(steps):
        row = []
        for i in range(steps):
            out = x[n * idx:n * (idx + 1)]
            if j != 0:
                out = out[..., padding:, :]
            if i != 0:
                out = out[..., :, padding:]
            if j != steps - 1:
                out = out[..., :-padding, :]
            if i != steps - 1:
                out = out[..., :, :-padding]
            row.append(out)
            idx += 1
        rows.append(torch.cat(row, dim=-1))
    return torch.cat(rows, dim=-2)


def forward(cfg: dict, sd: Dict[str, torch.Tensor], x: torch.Tensor, *, dtype: torch.dtype = torch.float32,
            gemm_inputs: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """(N, 3, S, S) float32 images -> (N, 1, S, S) float32 logits, in eval
    mode, in ``dtype`` as the module's docstring says."""
    d = cfg["depth_pro"]
    D, p, heads, eps = d["embed_dim"], d["patch_size"], d["num_heads"], d["layer_norm_eps"]
    dh = D // heads
    g = grid(cfg)
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
        m = qkv.shape[0]
        q, k, v = qkv.reshape(m, -1, 3, heads, dh).permute(2, 0, 3, 1, 4)
        probs = torch.softmax(f32(q) @ f32(k).transpose(-1, -2) / math.sqrt(dh), dim=-1)
        return (probs.to(dtype) @ v).transpose(1, 2).reshape(m, -1, D)

    def vit(e, tiles, raw=()):
        """The final normed tokens' maps and the raw hooked blocks' maps,
        (m, D, g, g) each, class token dropped."""
        m = tiles.shape[0]
        t = F.conv2d(tiles, w(f"{e}.patch_embed.proj.weight"), w(f"{e}.patch_embed.proj.bias"), stride=p)
        t = torch.cat([w(f"{e}.cls_token").expand(m, -1, -1), t.flatten(2).transpose(1, 2)], dim=1)
        t = t + w(f"{e}.pos_embed")
        hooked = []
        for i in range(d["depth"]):
            b = f"{e}.blocks.{i}"
            t = scaled_add(t, linear(attention(linear(layer_norm(t, f"{b}.norm1"), f"{b}.attn.qkv")),
                                     f"{b}.attn.proj"), f"{b}.ls1.gamma")
            t = scaled_add(t, linear(gelu(linear(layer_norm(t, f"{b}.norm2"), f"{b}.mlp.fc1")), f"{b}.mlp.fc2"),
                           f"{b}.ls2.gamma")
            if i in raw:
                hooked.append(t)

        def maps(tokens):
            return tokens[:, 1:].transpose(1, 2).reshape(m, D, g, g)

        return maps(layer_norm(t, f"{e}.norm")), [maps(h) for h in hooked]

    def conv(t, key, bias=True, **kw):
        return F.conv2d(t, w(f"{key}.weight"), w(f"{key}.bias") if bias else None, **kw)

    def deconv(t, key, bias=True):
        return F.conv_transpose2d(t, w(f"{key}.weight"), w(f"{key}.bias") if bias else None, stride=2)

    def upsample(t, key, layers):
        t = conv(t, f"{key}.0", bias=False)
        for i in range(layers):
            t = deconv(t, f"{key}.{i + 1}", bias=False)
        return t

    def bias_relu(t, key):  # relu(conv + bias) in float32, rounded once
        return torch.relu(f32(t) + f32(w(f"{key}.bias")).view(1, -1, 1, 1)).to(dtype)

    def unit(t, key):
        y = bias_relu(conv(torch.relu(t), f"{key}.conv1", bias=False, padding=1), f"{key}.conv1")
        return conv(y, f"{key}.conv2", padding=1) + t

    def fusion(i, t, skip):
        r = f"decoder.fusions.{i}"
        if skip is not None:
            t = t + unit(skip, f"{r}.resConfUnit1")
        t = unit(t, f"{r}.resConfUnit2")
        if i:
            t = deconv(t, f"{r}.deconv", bias=False)
        return conv(t, f"{r}.out_conv")

    # encoder
    x1 = F.interpolate(x, scale_factor=0.5, mode="bilinear", align_corners=False)
    x2 = F.interpolate(x, scale_factor=0.25, mode="bilinear", align_corners=False)
    x0_tiles, x1_tiles = split(x, tile(cfg), SPLITS[0][1]), split(x1, tile(cfg), SPLITS[1][1])
    tiles = torch.cat([x0_tiles, x1_tiles, x2]).to(dtype)
    a, b = x0_tiles.shape[0], x1_tiles.shape[0]
    final, (hook0, hook1) = vit(ENCODERS[0], tiles, raw=tuple(d["hooks"]))
    p0, p1 = d["merge_padding"]
    latent0 = upsample(merge(hook0[:a], n, p0), "encoder.upsample_latent0", 3)
    latent1 = upsample(merge(hook1[:a], n, p0), "encoder.upsample_latent1", 2)
    f0 = upsample(merge(final[:a], n, p0), "encoder.upsample0", 1)
    f1 = upsample(merge(final[a:a + b], n, p1), "encoder.upsample1", 1)
    f2 = upsample(final[a + b:], "encoder.upsample2", 1)
    glob, _ = vit(ENCODERS[1], x2.to(dtype))
    glob = deconv(glob, "encoder.upsample_lowres")
    levels: List[torch.Tensor] = [latent0, latent1, f0, f1, conv(torch.cat([f2, glob], dim=1), "encoder.fuse_lowres")]

    # decoder
    path = fusion(4, conv(levels[4], "decoder.convs.4", bias=False, padding=1), None)
    for i in range(3, -1, -1):
        e = levels[i] if i == 0 else conv(levels[i], f"decoder.convs.{i}", bias=False, padding=1)
        path = fusion(i, path, e)

    # head
    y = deconv(conv(path, "head.0", padding=1), "head.1")
    y = bias_relu(conv(y, "head.2", bias=False, padding=1), "head.2")
    return f32(conv(y, "head.4"))


def network_input(cfg: dict, frames: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """(n, 6, H, W) dual frames and a (6, H, W) base in [0, 255] -> the
    (2n, 3, S, S) input, the left fingers' rows first: the difference
    image, the bilinear resize (``align_corners=False``), ``(x - mean) /
    std`` per channel."""
    n, _, fh, fw = frames.shape
    fingers = frames.reshape(n, 2, 3, fh, fw)
    if cfg["use_difference_image"]:
        fingers = (fingers - base.reshape(1, 2, 3, fh, fw) + 255.0) / 2.0
    fingers = fingers.transpose(0, 1).reshape(2 * n, 3, fh, fw)
    if cfg["interp_method"] != "bilinear" or cfg["image_normalization_method"] != "mean_std":
        raise ValueError("the Depth Pro reference resizes bilinearly and normalizes by mean_std only")
    x = F.interpolate(fingers, size=tuple(cfg["input_tactile_image_size"]), mode="bilinear", align_corners=False)
    _, _, mean, std = cfg["image_normalization_parameters"]
    mean, std = (torch.tensor(v, dtype=torch.float32, device=x.device).view(1, 3, 1, 1) for v in (mean, std))
    return (x - mean) / std


@torch.no_grad()
def predict(cfg: dict, sd, frames: torch.Tensor, base: torch.Tensor, *, dtype: torch.dtype = torch.float32,
            gemm_inputs=None) -> torch.Tensor:
    """(n, 6, H, W) dual frames -> (n, 2, H, W) depth in mm, one dual frame
    at a time; the network in dtype (``forward``), the rest in float32."""
    if cfg.get("output_interp_method", cfg["interp_method"]) != "area":
        raise ValueError("the Depth Pro reference resizes back by area only")
    out = []
    with no_tf32():
        for i in range(frames.shape[0]):
            one = frames[i:i + 1]
            y = forward(cfg, sd, network_input(cfg, one, base), dtype=dtype, gemm_inputs=gemm_inputs)
            out.append(ref_serving.depth_mm(cfg, y, 1))
    return torch.cat(out)
