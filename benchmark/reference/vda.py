"""The plain reference of Video Depth Anything's serving chain: float32
PyTorch with TF32 off, no kernels, no cache, no fusion, written from the
published model (https://github.com/DepthAnything/Video-Depth-Anything:
``video_depth_anything/dpt_temporal.py::DPTHeadTemporal`` and
``video_depth_anything/motion_module/motion_module.py``) over a state dict
of its layout, the encoder and the per-frame head as Depth Anything V2's
(``reference/dpt.py``).

- The chain: ``reference/dpt.py``'s front end (difference image, area
  resize, ``mean_std``), the network over each finger's frames in time
  order, a clip at a time (consecutive clips of ``num_frames``, the last
  one shorter where they do not divide the frames), the depth
  denormalization and the area resize back to the frame.
- The encoder, DINOv2 without registers, runs per frame, in blocks of
  ``ENCODER_BLOCK`` frames; the head runs on the whole clip.
- The head: DPT's (1x1 projections, the resizes, ``layer{i}_rn``, four
  fusion blocks, the output convs), with a temporal module on ``layer_3``
  and ``layer_4`` after their resize, and on ``path_4`` and ``path_3``
  after ``refinenet4`` and ``refinenet3``.
- A temporal module on a clip's (t, C, h, w) map x: GroupNorm (32 groups,
  eps 1e-6) per frame; the (position, frame, C) tokens through
  ``proj_in``; two attention blocks, each ``h + to_out(attn(LayerNorm(h) +
  pe[:t]))`` with q, k, v without bias, ``temporal_heads`` heads and
  ``softmax(q k^T / sqrt(head dim)) v`` over the clip's frames at each
  position, ``pe`` the sinusoidal table (``sinusoid_table``, computed
  here, not read from the state dict); ``h + W2(a * gelu_erf(g))`` with
  ``[a, g] = W1(LayerNorm(h))``; ``x + proj_out(h)``.
- Departures from the published model, the configuration's ``assumed``:
  no sliding windows (back-to-back clips), no ReLU after the last 1x1
  conv, the position table not resampled.
- ``dtype=torch.bfloat16`` computes the same model as the bfloat16
  program rounds it, as ``reference/dpt.py`` states it; besides, the
  GroupNorm and the temporal LayerNorms in float32 on bfloat16 inputs,
  rounded once; the table rounded to bfloat16 and added in it; GELU
  rounded, then its product with ``a``. ``gemm_inputs`` rounds the inputs
  of the encoder's matrix products, as ``reference/dpt.py``'s does.

It imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import dpt as ref_dpt
from benchmark.reference import serving as ref_serving
from benchmark.reference.unet import no_tf32

ENCODER_BLOCK = 8  # frames an encoder pass
GROUPS, GROUP_EPS, NORM_EPS = 32, 1e-6, 1e-5
SITES = ("layer3", "layer4", "path4", "path3")  # motion_modules.{0..3}


def temporal_widths(cfg: dict) -> Tuple[int, ...]:
    """The channels of the four temporal modules, in ``SITES`` order."""
    d = cfg["dpt"]
    oc = d["out_channels"]
    return oc[2], oc[3], d["features"], d["features"]


def temporal_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """The temporal modules' state-dict entries, the published names under
    the head."""
    length = cfg["dpt"]["num_frames"]
    s: Dict[str, Tuple[int, ...]] = {}
    for i, c in enumerate(temporal_widths(cfg)):
        r = f"depth_head.motion_modules.{i}.temporal_transformer"
        b = f"{r}.transformer_blocks.0"
        s[f"{r}.norm.weight"] = s[f"{r}.norm.bias"] = (c,)
        for lin in ("proj_in", "proj_out"):
            s[f"{r}.{lin}.weight"], s[f"{r}.{lin}.bias"] = (c, c), (c,)
        for j in range(2):
            a = f"{b}.attention_blocks.{j}"
            for proj in ("to_q", "to_k", "to_v"):
                s[f"{a}.{proj}.weight"] = (c, c)
            s[f"{a}.to_out.0.weight"], s[f"{a}.to_out.0.bias"] = (c, c), (c,)
            s[f"{a}.pos_encoder.pe"] = (1, length, c)
            s[f"{b}.norms.{j}.weight"] = s[f"{b}.norms.{j}.bias"] = (c,)
        s[f"{b}.ff.net.0.proj.weight"], s[f"{b}.ff.net.0.proj.bias"] = (8 * c, c), (8 * c,)
        s[f"{b}.ff.net.2.weight"], s[f"{b}.ff.net.2.bias"] = (c, 4 * c), (c,)
        s[f"{b}.ff_norm.weight"] = s[f"{b}.ff_norm.bias"] = (c,)
    return s


def state_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every entry of the model's state dict and its shape."""
    return {**ref_dpt.state_shapes(cfg), **temporal_shapes(cfg)}


def sinusoid_table(length: int, dim: int) -> torch.Tensor:
    """(length, dim): ``[s, 2i] = sin(s * 10000^(-2i/dim))``, ``[s, 2i+1] =
    cos(s * 10000^(-2i/dim))``, in float64 rounded to float32."""
    s = torch.arange(length, dtype=torch.float64).unsqueeze(1)
    i = torch.arange(0, dim, 2, dtype=torch.float64)
    angle = s * torch.pow(10000.0, -i / dim)
    table = torch.empty(length, dim, dtype=torch.float64)
    table[:, 0::2], table[:, 1::2] = torch.sin(angle), torch.cos(angle)
    return table.float()


class _Ops:
    """The plain ops in ``dtype``, with the rounding the module's docstring
    states."""

    def __init__(self, sd, dtype, gemm_inputs):
        self.sd, self.dtype, self.gemm_inputs = sd, dtype, gemm_inputs

    def w(self, key):
        return self.sd[key].to(self.dtype)

    def layer_norm(self, t, prefix, eps):
        d = t.shape[-1]
        return F.layer_norm(t.float(), (d,), self.w(f"{prefix}.weight").float(), self.w(f"{prefix}.bias").float(),
                            eps).to(self.dtype)

    def linear(self, t, prefix, bias=True, gemm=False):
        weight = self.w(f"{prefix}.weight")
        if gemm and self.gemm_inputs is not None:
            t, weight = self.gemm_inputs(t), self.gemm_inputs(weight)
        return F.linear(t, weight, self.w(f"{prefix}.bias") if bias else None)

    def gelu(self, t):
        t = t.float()
        return (0.5 * t * (1.0 + torch.erf(t / math.sqrt(2.0)))).to(self.dtype)

    def attention(self, q, k, v):
        """q, k, v (batch, heads, L, dh) -> (batch, L, heads * dh)."""
        probs = torch.softmax(q.float() @ k.float().transpose(-1, -2) / math.sqrt(q.shape[-1]), dim=-1)
        o = probs.to(self.dtype) @ v
        return o.transpose(1, 2).reshape(o.shape[0], o.shape[2], -1)

    def conv(self, t, key, bias=True, **kw):
        return F.conv2d(t, self.w(f"{key}.weight"), self.w(f"{key}.bias") if bias else None, **kw)


def encoder(cfg: dict, ops: _Ops, x: torch.Tensor) -> List[torch.Tensor]:
    """(n, 3, H, W) images -> the four hooks' (n, tokens, D), class token
    dropped: DINOv2 as ``reference/dpt.py`` writes it."""
    d = cfg["dpt"]
    D, p, heads, eps = d["embed_dim"], d["patch_size"], d["num_heads"], d["layer_norm_eps"]
    n = x.shape[0]
    pe = "pretrained.patch_embed.proj"
    t = ops.conv(x.to(ops.dtype), pe, stride=p).flatten(2).transpose(1, 2)
    t = torch.cat([ops.w("pretrained.cls_token").expand(n, -1, -1), t], dim=1) + ops.w("pretrained.pos_embed")

    def scaled_add(t, y, key):
        return (t.float() + y.float() * ops.w(key).float()).to(ops.dtype)

    hooks = []
    for i in range(d["depth"]):
        b = f"pretrained.blocks.{i}"
        qkv = ops.linear(ops.layer_norm(t, f"{b}.norm1", eps), f"{b}.attn.qkv", gemm=True)
        q, k, v = qkv.reshape(n, -1, 3, heads, D // heads).permute(2, 0, 3, 1, 4)
        t = scaled_add(t, ops.linear(ops.attention(q, k, v), f"{b}.attn.proj", gemm=True), f"{b}.ls1.gamma")
        m = ops.linear(ops.gelu(ops.linear(ops.layer_norm(t, f"{b}.norm2", eps), f"{b}.mlp.fc1", gemm=True)),
                       f"{b}.mlp.fc2", gemm=True)
        t = scaled_add(t, m, f"{b}.ls2.gamma")
        if i in d["hooks"]:
            hooks.append(ops.layer_norm(t, "pretrained.norm", eps)[:, 1:])
    return hooks


def temporal_module(cfg: dict, ops: _Ops, i: int, x: torch.Tensor) -> torch.Tensor:
    """Temporal module i over one clip's (t, C, h, w) map, frames in time
    order."""
    heads = cfg["dpt"]["temporal_heads"]
    t, c, h, w = x.shape
    r = f"depth_head.motion_modules.{i}.temporal_transformer"
    b = f"{r}.transformer_blocks.0"
    g = F.group_norm(x.float(), GROUPS, ops.w(f"{r}.norm.weight").float(), ops.w(f"{r}.norm.bias").float(),
                     GROUP_EPS).to(ops.dtype)
    tokens = ops.linear(g.permute(2, 3, 0, 1).reshape(h * w, t, c), f"{r}.proj_in")  # (position, frame, C)
    table = sinusoid_table(t, c).to(x.device, ops.dtype)
    for j in range(2):
        a = f"{b}.attention_blocks.{j}"
        n = ops.layer_norm(tokens, f"{b}.norms.{j}", NORM_EPS) + table
        q, k, v = (ops.linear(n, f"{a}.{proj}", bias=False).reshape(h * w, t, heads, c // heads).transpose(1, 2)
                   for proj in ("to_q", "to_k", "to_v"))
        tokens = tokens + ops.linear(ops.attention(q, k, v), f"{a}.to_out.0")
    a, gate = ops.linear(ops.layer_norm(tokens, f"{b}.ff_norm", NORM_EPS), f"{b}.ff.net.0.proj").chunk(2, dim=-1)
    tokens = tokens + ops.linear(a * ops.gelu(gate), f"{b}.ff.net.2")
    y = ops.linear(tokens, f"{r}.proj_out")
    return x + y.reshape(h, w, t, c).permute(2, 3, 0, 1)


def head(cfg: dict, ops: _Ops, hooks: List[torch.Tensor], temporal: bool = True) -> torch.Tensor:
    """One clip's hooks -> its (t, 1, H, W) float32 logits: DPT's head with
    the temporal modules (``temporal=False`` leaves them out)."""
    d = cfg["dpt"]
    D, p = d["embed_dim"], d["patch_size"]
    gh, gw = ref_dpt.grid(cfg)
    n = hooks[0].shape[0]
    h = "depth_head"
    s = f"{h}.scratch"

    def module(i, t):
        return temporal_module(cfg, ops, i, t) if temporal else t

    def bias_relu(t, key):
        return torch.relu(t.float() + ops.w(f"{key}.bias").float().view(1, -1, 1, 1)).to(ops.dtype)

    def unit(t, key):
        y = bias_relu(ops.conv(torch.relu(t), f"{key}.conv1", bias=False, padding=1), f"{key}.conv1")
        return ops.conv(y, f"{key}.conv2", padding=1) + t

    def fusion(i, t, skip, size):
        r = f"{s}.refinenet{i}"
        if skip is not None:
            t = t + unit(skip, f"{r}.resConfUnit1")
        t = F.interpolate(unit(t, f"{r}.resConfUnit2"), size=size, mode="bilinear", align_corners=True)
        return ops.conv(t, f"{r}.out_conv")

    layers = []
    for i, t in enumerate(hooks):
        y = ops.conv(t.transpose(1, 2).reshape(n, D, gh, gw), f"{h}.projects.{i}")
        if i < 2:
            key = f"{h}.resize_layers.{i}"
            y = F.conv_transpose2d(y, ops.w(f"{key}.weight"), ops.w(f"{key}.bias"), stride=4 // (i + 1))
        elif i == 3:
            y = ops.conv(y, f"{h}.resize_layers.3", stride=2, padding=1)
        if i >= 2:
            y = module(i - 2, y)
        layers.append(ops.conv(y, f"{s}.layer{i + 1}_rn", bias=False, padding=1))
    l1, l2, l3, l4 = layers
    path = module(2, fusion(4, l4, None, l3.shape[2:]))
    path = module(3, fusion(3, path, l3, l2.shape[2:]))
    path = fusion(2, path, l2, l1.shape[2:])
    path = fusion(1, path, l1, (2 * l1.shape[2], 2 * l1.shape[3]))
    y = F.interpolate(ops.conv(path, f"{s}.output_conv1", padding=1), size=(gh * p, gw * p), mode="bilinear",
                      align_corners=True)
    y = bias_relu(ops.conv(y, f"{s}.output_conv2.0", bias=False, padding=1), f"{s}.output_conv2.0")
    return ops.conv(y, f"{s}.output_conv2.2").float()


def clips(frames: int, length: int) -> List[Tuple[int, int]]:
    """(start, stop) of each clip of a stream of ``frames`` frames."""
    return [(s, min(frames, s + length)) for s in range(0, frames, length)]


def forward_clip(cfg: dict, sd: Dict[str, torch.Tensor], x: torch.Tensor, *, dtype: torch.dtype = torch.float32,
                 gemm_inputs: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 temporal: bool = True) -> torch.Tensor:
    """One clip's (t, 3, H, W) float32 images, in time order -> its (t, 1,
    H, W) float32 logits, in ``dtype``."""
    ops = _Ops(sd, dtype, gemm_inputs)
    parts = [encoder(cfg, ops, x[s:s + ENCODER_BLOCK]) for s in range(0, x.shape[0], ENCODER_BLOCK)]
    hooks = [torch.cat(hs) for hs in zip(*parts)]
    del parts
    return head(cfg, ops, hooks, temporal)


def forward(cfg: dict, sd: Dict[str, torch.Tensor], x: torch.Tensor, streams: int, **kw) -> torch.Tensor:
    """(n, 3, H, W) images, ``streams`` runs of n / streams frames in time
    order one after another -> (n, 1, H, W) float32 logits, each run cut
    into clips of ``num_frames``, a clip at a time (``forward_clip``)."""
    frames = x.shape[0] // streams
    out = []
    for r in range(streams):
        for s, e in clips(frames, cfg["dpt"]["num_frames"]):
            out.append(forward_clip(cfg, sd, x[r * frames + s:r * frames + e], **kw))
    return torch.cat(out)


@torch.no_grad()
def predict(cfg: dict, sd, frames: torch.Tensor, base: torch.Tensor, **kw) -> torch.Tensor:
    """(n, 6, H, W) consecutive dual frames -> (n, 2, H, W) depth in mm:
    each finger's n frames in clips (``forward``), the rest in float32."""
    with no_tf32():
        y = forward(cfg, sd, ref_dpt.network_input(cfg, frames, base), 2, **kw)
        return ref_serving.depth_mm(cfg, y, frames.shape[0])
