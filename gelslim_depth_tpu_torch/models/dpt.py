"""Dense-prediction transformer for tactile depth, eval forward: a DINOv2
ViT encoder and a DPT head, laid out as Depth Anything V2 lays them out
(https://github.com/DepthAnything/Depth-Anything-V2: ``dinov2.py`` and
``dpt.py``). Submodule and parameter names are its state-dict keys
(``pretrained.blocks.{i}.attn.qkv``, ``depth_head.scratch.refinenet1
.resConfUnit1.conv1``, ...), so its checkpoints' layout loads with
``load_state_dict``.

- Encoder: a patch-embedding conv (kernel and stride the patch; run as a
  matmul over the patches), a class
  token and a learned position table, blocks of pre-norm attention and
  an exact-GELU MLP, each branch scaled by its LayerScale before the
  residual add; LayerNorm eps and qkv and proj biases as published.
- The hooked blocks' outputs go through the final norm, their class
  token dropped, to the head.
- Head: per hook a 1x1 projection, then a transposed conv (k4 s4, k2 s2),
  an identity or a 3x3 s2 conv; the ``layer{i}_rn`` 3x3 convs to
  ``features``; four fusion blocks (two residual conv units, ReLU -> 3x3
  -> ReLU -> 3x3 plus the skip, a bilinear resize with
  ``align_corners=True``, a 1x1); the output convs (3x3 to features / 2, a
  bilinear resize to the patch grid x patch, 3x3 to ``head_features``,
  ReLU, 1x1 to one channel).

Departures, each for the serving system's target and weights:
- the published model's ReLU after the last 1x1 conv is left out: the
  target is the normalized depth in [-0.9, 0];
- the position table is held at the configuration's own patch grid
  (1 + grid entries), not resampled from a 37x37 table on every call.

Compute dtype (``to_compute_dtype``): every weight and the residual stream
in it; LayerNorm with float32 statistics, rounded to it; attention through
``F.scaled_dot_product_attention`` pinned to one fused backend
(``attention_backend``: cuDNN's for bfloat16 on CUDA, memory-efficient
for float32 there; never the math backend on CUDA), softmax inside it; the
LayerScale and residual add as one ``addcmul``. Where a LayerNorm follows
that add (each block's norm2, the next block's norm1: 2 x depth - 1 sites
a call), the two are ``residual_layer_norm``, one hand-written kernel on
the card that writes the sum, bit for bit ``addcmul``'s, and its
LayerNorm (statistics summed in the kernel's own order). A head conv whose
bias feeds a ReLU (the first conv of each residual unit, the
``head_features``-wide output conv) runs without its bias, and
``conv_epilogue``'s BatchNorm form finishes it (scale 1, shift the bias in
float32, ``relu``), rounded once. On CUDA every other head conv with a bias
runs without it too, so no bias is left to aten's strided broadcast add
after cuDNN's conv (``_conv``): at the second conv of each residual unit
``conv_epilogue``'s residual form adds the bias and the unit's skip, each
rounded as aten's two adds; at the rest (the reassembly's resize convs,
each fusion block's ``out_conv``, ``output_conv1``, the last 1x1) its bias
form. On the CPU those convs keep their bias, which the CPU's conv adds
before it rounds. The head runs channels-last: the tokens already are.
Its five bilinear resizes (``align_corners=True``) are
``bilinear_resize``, one hand-written kernel a resize on the card, bit for
bit the library's ``F.interpolate``. float32 runs with TF32 off.

Temporal head (``DPTConfig.num_frames`` > 0): Video Depth Anything's
``DPTHeadTemporal`` (https://github.com/DepthAnything/Video-Depth-Anything:
``video_depth_anything/dpt_temporal.py``, ``motion_module/motion_module.py``).
Four ``TemporalModule``s, each attending across the frames of a clip at
every spatial position, sit on ``layer_3`` and ``layer_4`` after their
projection and resize (before ``layer{3,4}_rn``) and on ``path_4`` and
``path_3`` after ``refinenet4`` and ``refinenet3``; everything else runs
per frame. On a map ``x`` of C channels over a clip of t <= num_frames
frames, with ``temporal_heads`` heads of C / heads:

1. ``h = GroupNorm(32 groups, eps 1e-6, affine)(x)``, per frame;
2. the tokens of the clip's frames, ``h = proj_in(h)`` (C -> C, bias);
3. two attention blocks: ``n = LayerNorm_j(h)`` (eps 1e-5), plus the
   sinusoidal table ``pe[s, 2i] = sin(s 10000^(-2i/C))``, ``pe[s, 2i+1] =
   cos(...)`` at the frame's place s in the clip; q, k, v projections
   without bias; softmax attention over the clip's frames at each
   position, scale (C / heads)^-1/2; ``h += to_out(o)`` (bias);
4. ``h += W2(a * gelu_erf(g))``, ``[a, g] = W1(LayerNorm_ff(h))``, W1 C ->
   8C and W2 4C -> C, both with bias (GEGLU);
5. ``x + proj_out(h)`` (C -> C, bias).

Clips: ``DPT.forward(x, streams)`` takes x's rows as ``streams`` runs of
equal length, one after another (a finger's frames each, in time order),
and cuts each run into consecutive clips of ``num_frames``; a last,
shorter clip attends over its own frames with the table's rows 0...t-1.
The module computes in clip, position, frame order: its GroupNorm writes
the frames' tokens regrouped so that each position's frames of a clip lie
together, the blocks' LayerNorms, linears and SDPA then run on that
layout with no copy, and the last residual add reads ``proj_out``'s
output back into the map's own order. State-dict names are the
published module's (``motion_modules.{i}.temporal_transformer.{norm,
proj_in, transformer_blocks.0.attention_blocks.{j}.{to_q, to_k, to_v,
to_out.0, pos_encoder.pe}, transformer_blocks.0.{norms.{j}, ff.net.0.proj,
ff.net.2, ff_norm}, proj_out}``) under this model's ``depth_head``, where
the published model names its head ``head``; ``pos_encoder.pe``, the
(1, num_frames, C) table, is taken to be a buffer that the published
checkpoint holds (not confirmed against a checkpoint). Departures: the
published sliding-window inference (windows overlapping by 10 frames,
keyframes, scale-and-shift alignment between windows) is left out, and
back-to-back clips are served; the published ``proj_out`` is
zero-initialised, here it is a weight like any other (the weights come
from the caller); the DPT's departures above.

Spans (``utils.profiling.span``): ``dpt.encoder`` (patch embedding, the
blocks, the hooks' norm), a ``dpt.block`` a block (site its index; its
residual adds with the LayerNorms they feed, the next block's norm1
among them) holding ``dpt.attention`` (the head split, the SDPA call,
the merge) and ``dpt.mlp`` (fc1, GELU, fc2); ``dpt.head`` holding
``dpt.reassemble`` (projections, resizes, ``layer{i}_rn``), ``dpt.fusion``
(sites ``refinenet4`` ... ``refinenet1``) and ``dpt.output``, each conv of
which is a ``head.conv`` span of its own (``_head_conv``: the conv, or
the 1x1 projection's matrix product with its bias, and nothing else; its
``conv_epilogue``, the ReLUs, adds and resizes outside), 32 a call at
sites ``layer{i}.proj``, ``layer{i}.resize`` and ``layer{i}_rn`` in
``dpt.reassemble``, ``unit{1,2}.conv{1,2}`` and ``out`` in each
``dpt.fusion``, ``output_conv1``, ``output_conv2.0`` and ``output_conv2.2``
in ``dpt.output``; with the temporal head a ``dpt.temporal`` a module
(sites ``layer3`` and ``layer4`` inside ``dpt.reassemble``, ``path4`` and
``path3`` after their fusion block), holding a
``dpt.temporal_attention`` an attention block (site its index:
the head split, the SDPA call, the merge) and ``dpt.temporal_ff`` (the
feed-forward and its residual add). ``DPT.attention_calls`` counts the
encoder's SDPA calls by the backend pinned, ``DPT.temporal_attention_calls``
the temporal modules' (``temporal_attention_backend``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from gelslim_depth_tpu_torch.ops.kernels.bilinear_resize import bilinear_resize
from gelslim_depth_tpu_torch.ops.kernels.conv_epilogue import conv_epilogue
from gelslim_depth_tpu_torch.ops.kernels.residual_layer_norm import residual_layer_norm
from gelslim_depth_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    """Depth Anything V2's ``vitl`` by default: DINOv2 ViT-L/14 and its
    DPT head. ``image_size`` is the network input's (H, W), a multiple of
    the patch; ``GelslimConfig.dpt_config()`` sets it from the input size."""

    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-6
    hooks: Tuple[int, ...] = (4, 11, 17, 23)
    features: int = 256
    out_channels: Tuple[int, ...] = (256, 512, 1024, 1024)
    head_features: int = 32
    # Video Depth Anything's temporal head: clips of num_frames frames
    # (0, the per-frame DPT), temporal_heads heads a temporal module
    num_frames: int = 0
    temporal_heads: int = 8
    image_size: Optional[Tuple[int, int]] = None

    @classmethod
    def from_dict(cls, d: dict) -> "DPTConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in names})

    @property
    def temporal(self) -> bool:
        """Whether the head attends across the frames of a clip."""
        return self.num_frames > 0

    @property
    def grid(self) -> Tuple[int, int]:
        """The patch grid (h, w) of ``image_size``."""
        if self.image_size is None:
            raise ValueError("DPTConfig.image_size is not set")
        h, w = self.image_size
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"the input {h}x{w} is not a multiple of the patch {p}")
        return h // p, w // p


def attention_backend(device: torch.device, dtype: torch.dtype):
    """The SDPA backend pinned for a device and compute dtype: cuDNN's
    attention for bfloat16 on CUDA (on an H100 at the flagship's shape,
    128 x 16 heads x 661 tokens of 64, 0.82 ms a block against flash's
    1.12), the memory-efficient kernel for float32 there (neither takes
    float32), flash's CPU kernel on the CPU."""
    if device.type != "cuda":
        return SDPBackend.FLASH_ATTENTION
    return SDPBackend.EFFICIENT_ATTENTION if dtype == torch.float32 else SDPBackend.CUDNN_ATTENTION


def temporal_attention_backend(device: torch.device, dtype: torch.dtype, head_dim: int):
    """The SDPA backend pinned for a temporal module: ``attention_backend``'s,
    but the memory-efficient kernel for bfloat16 heads narrower than 64 on
    CUDA (on an H100 at the video cell's shapes, sequences of 32 frames in
    8 heads: heads of 32 over 10,560 sequences 0.84 ms against cuDNN's
    1.35, over 2,640 0.22 against 0.35; heads of 128, cuDNN 0.46 against
    0.55)."""
    if device.type == "cuda" and dtype == torch.bfloat16 and head_dim < 64:
        return SDPBackend.EFFICIENT_ATTENTION
    return attention_backend(device, dtype)


@contextlib.contextmanager
def _no_tf32(dtype: torch.dtype):
    """TF32 off for float32 convs and matmuls; other dtypes leave the flags."""
    if dtype != torch.float32:
        yield
        return
    keep = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = keep


def _epilogue_vectors(module: nn.Module, name: str, conv: nn.Conv2d) -> None:
    """``{name}_scale`` (ones) and ``{name}_shift`` (the conv's bias), the
    float32 vectors of its epilogue, as buffers the state dict does not
    hold."""
    with torch.no_grad():
        shift = conv.bias.float().contiguous()
        module.register_buffer(f"{name}_scale", torch.ones_like(shift), persistent=False)
        module.register_buffer(f"{name}_shift", shift, persistent=False)


def _epilogue_bias(x: torch.Tensor) -> bool:
    """Whether a head conv on x runs without its bias, one ``conv_epilogue``
    adding it: on CUDA, where PyTorch runs a conv with a bias as cuDNN's
    conv, then its own bias add (aten's strided kernel, at ~38% of its byte
    bound on a channels-last map), rounding to the compute dtype between
    the two as the kernel does. Not on the CPU, whose conv adds its bias in
    float32 before it rounds: a bfloat16 add after it would round twice."""
    return x.is_cuda


def _head_conv(site: str, fn, *args, **kw) -> torch.Tensor:
    """``fn(*args, **kw)``, one conv of a head (``F.conv2d``,
    ``F.conv_transpose2d``, or ``F.linear`` as a 1x1 conv on tokens), alone
    in a ``head.conv`` span at ``site``: the passes around it stay outside."""
    with span("head.conv", site):
        return fn(*args, **kw)


def _conv(site: str, fn, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          residual: Optional[torch.Tensor] = None, **kw) -> torch.Tensor:
    """``fn(x, weight, bias, **kw)`` (``F.conv2d`` or ``F.conv_transpose2d``),
    plus ``residual`` where one is given: where ``_epilogue_bias``, the conv
    without its bias and one ``conv_epilogue`` (its bias form, or its
    residual form: the bias add, then the skip add, each rounded to the
    compute dtype); else the conv with its bias and aten's add. The conv is
    a ``head.conv`` span at ``site`` (``_head_conv``)."""
    if _epilogue_bias(x):
        return conv_epilogue(_head_conv(site, fn, x, weight, **kw), bias=bias, residual=residual)
    y = _head_conv(site, fn, x, weight, bias, **kw)
    return y if residual is None else y + residual


def _bias_relu(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """relu(y + bias) of a conv run without its bias, in float32 and rounded
    to y's dtype once: one ``conv_epilogue`` in its BatchNorm form."""
    return conv_epilogue(y, bn_mul=scale, bn_add=shift, act="relu")


# ---------------------------------------------------------------------------
# encoder (DINOv2)
# ---------------------------------------------------------------------------

class PatchEmbed(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size)


class Attention(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.qkv = nn.Linear(cfg.embed_dim, 3 * cfg.embed_dim)
        self.proj = nn.Linear(cfg.embed_dim, cfg.embed_dim)


class Mlp(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.embed_dim, cfg.mlp_ratio * cfg.embed_dim)
        self.fc2 = nn.Linear(cfg.mlp_ratio * cfg.embed_dim, cfg.embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(F.gelu(F.linear(x, self.fc1.weight, self.fc1.bias)), self.fc2.weight, self.fc2.bias)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class Block(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        d, eps = cfg.embed_dim, cfg.layer_norm_eps
        self.norm1 = nn.LayerNorm(d, eps=eps)
        self.attn = Attention(cfg)
        self.ls1 = LayerScale(d)
        self.norm2 = nn.LayerNorm(d, eps=eps)
        self.mlp = Mlp(cfg)
        self.ls2 = LayerScale(d)

    def forward(self, x: torch.Tensor, h: Optional[torch.Tensor], backend,
                next_norm: Optional[nn.LayerNorm]) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x + ls1(attn(norm1(x))), then + ls2(mlp(norm2(x))); x (N, T, D).
        h is norm1(x) where the block before computed it with its last
        residual add, else None. Each residual add that a LayerNorm follows
        runs with it as one ``residual_layer_norm``: ls1's with norm2, ls2's
        with ``next_norm`` (the next block's norm1). Returns the new x and
        next_norm of it, or None where next_norm is None (the last block)."""
        n, t, d = x.shape
        heads = self.attn.num_heads
        if h is None:
            h = self.norm1(x)
        qkv = F.linear(h, self.attn.qkv.weight, self.attn.qkv.bias)
        with span("dpt.attention"):
            q, k, v = qkv.view(n, t, 3, heads, d // heads).permute(2, 0, 3, 1, 4).unbind(0)
            o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(n, t, d)
        DPT.attention_calls[backend.name] += 1
        x, h = _residual_norm(x, F.linear(o, self.attn.proj.weight, self.attn.proj.bias), self.ls1, self.norm2)
        with span("dpt.mlp"):
            m = self.mlp(h)
        if next_norm is None:
            return torch.addcmul(x, m, self.ls2.gamma), None
        return _residual_norm(x, m, self.ls2, next_norm)


def _residual_norm(x: torch.Tensor, branch: torch.Tensor, scale: LayerScale,
                   norm: nn.LayerNorm) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + scale(branch), norm of it), one ``residual_layer_norm``."""
    return residual_layer_norm(x, branch, scale.gamma, norm.weight, norm.bias, norm.eps)


class DinoEncoder(nn.Module):
    """DINOv2's ``DinoVisionTransformer`` without registers, its position
    table at the configuration's grid; ``forward`` returns the hooked
    blocks' outputs through the final norm, then the raw outputs of the
    blocks that ``raw`` names, class token dropped each."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        gh, gw = cfg.grid
        d = cfg.embed_dim
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + gh * gw, d))
        self.mask_token = nn.Parameter(torch.zeros(1, d))  # published key; eval never masks
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, raw: Tuple[int, ...] = ()) -> List[torch.Tensor]:
        n, c = x.shape[:2]
        p = self.cfg.patch_size
        gh, gw = self.cfg.grid
        # the stride-p conv as one matmul over the patches (on an H100 at
        # 128 images, 0.73 ms against cuDNN's conv's 3.46)
        patches = x.view(n, c, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5).reshape(n, gh * gw, c * p * p)
        pe = self.patch_embed.proj
        t = F.linear(patches, pe.weight.flatten(1), pe.bias)
        t = torch.cat([self.cls_token.expand(n, -1, -1), t], dim=1) + self.pos_embed
        backend = attention_backend(x.device, x.dtype)
        hooks, raw_out, h = [], [], None
        with sdpa_kernel([backend]):
            for i, block in enumerate(self.blocks):
                next_norm = self.blocks[i + 1].norm1 if i + 1 < len(self.blocks) else None
                with span("dpt.block", str(i)):
                    t, h = block(t, h, backend, next_norm)
                if i in self.cfg.hooks:
                    hooks.append(self.norm(t[:, 1:]))
                if i in raw:  # each block writes a new stream, so the view stays this block's output
                    raw_out.append(t[:, 1:])
        return hooks + raw_out


# ---------------------------------------------------------------------------
# head (DPT)
# ---------------------------------------------------------------------------

class ResidualConvUnit(nn.Module):
    """``x + conv2(relu(conv1(relu(x))))``; ``site`` (``unit1``, ``unit2``)
    names its convs' ``head.conv`` spans, ``<site>.conv1`` and
    ``<site>.conv2``."""

    def __init__(self, features: int, site: str):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.sites = (f"{site}.conv1", f"{site}.conv2")
        self.fold_bias()

    def fold_bias(self) -> None:
        _epilogue_vectors(self, "conv1", self.conv1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _bias_relu(_head_conv(self.sites[0], F.conv2d, torch.relu(x), self.conv1.weight, padding=1),
                       self.conv1_scale, self.conv1_shift)
        return _conv(self.sites[1], F.conv2d, h, self.conv2.weight, self.conv2.bias, residual=x, padding=1)


class FeatureFusionBlock(nn.Module):
    """``x (+ resConfUnit1(skip))``, ``resConfUnit2``, an upsample, a 1x1
    conv. The upsample is the DPT's bilinear resize to ``size``; with
    ``deconv`` (Depth Pro's ``FeatureFusionBlock2d``) a transposed conv k2
    s2 without bias in its place, and with neither none. Its convs'
    ``head.conv`` sites: ``unit1.conv1`` ... ``unit2.conv2``, ``deconv``,
    ``out``."""

    def __init__(self, features: int, deconv: bool = False):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features, "unit1")
        self.resConfUnit2 = ResidualConvUnit(features, "unit2")
        self.deconv = nn.ConvTranspose2d(features, features, 2, stride=2, bias=False) if deconv else None
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor],
                size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        if self.deconv is not None:
            x = _head_conv("deconv", F.conv_transpose2d, x, self.deconv.weight, stride=2)
        elif size is not None:
            x = bilinear_resize(x, size)
        return _conv("out", F.conv2d, x, self.out_conv.weight, self.out_conv.bias)


class Scratch(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        f = cfg.features
        for i, c in enumerate(cfg.out_channels, 1):
            setattr(self, f"layer{i}_rn", nn.Conv2d(c, f, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(f))
        self.output_conv1 = nn.Conv2d(f, f // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(f // 2, cfg.head_features, 3, padding=1), nn.ReLU(),
            nn.Conv2d(cfg.head_features, 1, 1), nn.ReLU(), nn.Identity(),
        )
        self.fold_bias()

    def fold_bias(self) -> None:
        _epilogue_vectors(self, "output", self.output_conv2[0])


# ---------------------------------------------------------------------------
# temporal modules (Video Depth Anything)
# ---------------------------------------------------------------------------

GROUP_NORM_GROUPS = 32
GROUP_NORM_EPS = 1e-6
TEMPORAL_LAYER_NORM_EPS = 1e-5


def sinusoid_table(length: int, dim: int) -> torch.Tensor:
    """(length, dim) float32: ``[s, 2i] = sin(s 10000^(-2i/dim))``,
    ``[s, 2i+1] = cos(...)``."""
    s = torch.arange(length, dtype=torch.float32).unsqueeze(1)
    freq = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32) * (-math.log(10000.0) / dim))
    table = torch.zeros(length, dim)
    table[:, 0::2] = torch.sin(s * freq)
    table[:, 1::2] = torch.cos(s * freq)
    return table


class PositionalEncoding(nn.Module):
    def __init__(self, dim: int, max_len: int):
        super().__init__()
        self.register_buffer("pe", sinusoid_table(max_len, dim).unsqueeze(0))


class TemporalAttention(nn.Module):
    def __init__(self, dim: int, heads: int, max_len: int):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim), nn.Identity()])  # [1]: the published dropout
        self.pos_encoder = PositionalEncoding(dim, max_len)

    def forward(self, n: torch.Tensor, backend, site: str) -> torch.Tensor:
        """to_out(attention over the frames) of n, (sequences, t, C): a
        position's frames of one clip a sequence, in time order."""
        s, t, c = n.shape
        n = n + self.pos_encoder.pe[0, :t]
        q, k, v = (F.linear(n, proj.weight) for proj in (self.to_q, self.to_k, self.to_v))
        with span("dpt.temporal_attention", site):
            q, k, v = (a.view(s, t, self.heads, c // self.heads).transpose(1, 2) for a in (q, k, v))
            o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(s, t, c)
        DPT.temporal_attention_calls[backend.name] += 1
        return F.linear(o, self.to_out[0].weight, self.to_out[0].bias)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(), nn.Linear(4 * dim, dim)])  # [1]: dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj = self.net[0].proj
        a, g = F.linear(x, proj.weight, proj.bias).chunk(2, dim=-1)
        return F.linear(a * F.gelu(g), self.net[2].weight, self.net[2].bias)


class TemporalTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, max_len: int):
        super().__init__()
        self.attention_blocks = nn.ModuleList(TemporalAttention(dim, heads, max_len) for _ in range(2))
        self.norms = nn.ModuleList(nn.LayerNorm(dim, eps=TEMPORAL_LAYER_NORM_EPS) for _ in range(2))
        self.ff = FeedForward(dim)
        self.ff_norm = nn.LayerNorm(dim, eps=TEMPORAL_LAYER_NORM_EPS)

    def forward(self, h: torch.Tensor, backend) -> torch.Tensor:
        for j, (attention, norm) in enumerate(zip(self.attention_blocks, self.norms)):
            h = h + attention(norm(h), backend, str(j))
        with span("dpt.temporal_ff"):
            return h + self.ff(self.ff_norm(h))


class TemporalTransformer3DModel(nn.Module):
    def __init__(self, dim: int, heads: int, max_len: int):
        super().__init__()
        self.norm = nn.GroupNorm(GROUP_NORM_GROUPS, dim, eps=GROUP_NORM_EPS, affine=True)
        self.proj_in = nn.Linear(dim, dim)
        self.transformer_blocks = nn.ModuleList([TemporalTransformerBlock(dim, heads, max_len)])
        self.proj_out = nn.Linear(dim, dim)


def _group_norm_regrouped(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """GroupNorm of x, (clips, t, positions, C), per frame: float32
    statistics, ``x * scale + shift`` in float32 rounded to x's dtype once,
    written (clips, positions, t, C)."""
    n, t, p, c = x.shape
    g = norm.num_groups
    xg = x.view(n, t, p, g, c // g)
    var, mean = torch.var_mean(xg.float(), dim=(2, 4), correction=0, keepdim=True)
    scale = torch.rsqrt(var + norm.eps) * norm.weight.float().view(g, c // g)
    shift = norm.bias.float().view(g, c // g) - mean * scale
    out = torch.empty((n, p, t, c), dtype=x.dtype, device=x.device)
    torch.addcmul(shift, xg, scale, out=out.view(n, p, t, g, c // g).transpose(1, 2))
    return out


class TemporalModule(nn.Module):
    """One of Video Depth Anything's temporal modules (the equations in the
    module's docstring) over maps of ``dim`` channels."""

    def __init__(self, dim: int, heads: int, max_len: int):
        super().__init__()
        self.temporal_transformer = TemporalTransformer3DModel(dim, heads, max_len)

    def forward(self, x: torch.Tensor, backend) -> torch.Tensor:
        """x (clips, t, h, w, C), contiguous (the channels-last maps of a
        clip's frames) -> x + proj_out(...), the same shape."""
        tt = self.temporal_transformer
        n, t, hh, ww, c = x.shape
        p = hh * ww
        h = F.linear(_group_norm_regrouped(x.view(n, t, p, c), tt.norm), tt.proj_in.weight, tt.proj_in.bias)
        h = tt.transformer_blocks[0](h.view(n * p, t, c), backend)
        y = F.linear(h, tt.proj_out.weight, tt.proj_out.bias).view(n, p, t, c)
        out = torch.empty_like(x)
        torch.add(x.view(n, t, p, c), y.transpose(1, 2), out=out.view(n, t, p, c))
        return out


def clip_runs(frames: int, length: int) -> List[Tuple[int, int, int]]:
    """(start, stop, clip length) of the runs of equal clips that cut a
    stream of ``frames`` frames into consecutive clips of ``length``: the
    whole clips, then the shorter last one where ``length`` does not
    divide ``frames``."""
    whole = frames - frames % length
    runs = [(0, whole, length)] if whole else []
    if whole < frames:
        runs.append((whole, frames, frames - whole))
    return runs


def temporal(module: TemporalModule, y: torch.Tensor, streams: int, length: int, backend) -> torch.Tensor:
    """The module over y, (B, C, h, w) channels-last, whose rows are
    ``streams`` runs of B / streams frames in time order, each cut into
    clips of ``length``; returns the same layout."""
    b, c, h, w = y.shape
    t = y.permute(0, 2, 3, 1).contiguous().view(streams, b // streams, h, w, c)
    runs = clip_runs(b // streams, length)
    if len(runs) == 1:
        out = module(t.view(-1, runs[0][2], h, w, c), backend)
    else:
        out = torch.empty_like(t)
        for start, stop, clip in runs:
            part = t[:, start:stop].reshape(-1, clip, h, w, c)
            out[:, start:stop] = module(part, backend).view(streams, stop - start, h, w, c)
    return out.view(b, h, w, c).permute(0, 3, 1, 2)


class DPTHead(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        oc = cfg.out_channels
        self.cfg = cfg
        self.projects = nn.ModuleList(nn.Conv2d(cfg.embed_dim, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1),
        ])
        self.scratch = Scratch(cfg)
        if cfg.temporal:
            # on layer_3, layer_4 (their reassembly widths), path_4, path_3
            widths = (oc[2], oc[3], cfg.features, cfg.features)
            self.motion_modules = nn.ModuleList(
                TemporalModule(c, cfg.temporal_heads, cfg.num_frames) for c in widths)

    def _temporal(self, i: int, site: str, y: torch.Tensor, streams: int) -> torch.Tensor:
        backend = temporal_attention_backend(y.device, y.dtype, y.shape[1] // self.cfg.temporal_heads)
        with span("dpt.temporal", site), sdpa_kernel([backend]):
            return temporal(self.motion_modules[i], y, streams, self.cfg.num_frames, backend)

    def _reassemble(self, hooks: List[torch.Tensor], streams: int) -> List[torch.Tensor]:
        """Each hook's (N, T, D) tokens -> its ``layer{i}_rn`` map, (N,
        features, h, w) channels-last: the 1x1 projection as a matmul on the
        tokens, whose (N, h, w, C) layout is channels-last NCHW; with the
        temporal head, layer_3 and layer_4 through their temporal modules
        before ``layer{i}_rn``."""
        n = hooks[0].shape[0]
        gh, gw = self.cfg.grid
        out = []
        for i, (t, proj, resize) in enumerate(zip(hooks, self.projects, self.resize_layers), 1):
            y = _head_conv(f"layer{i}.proj", F.linear, t, proj.weight.flatten(1), proj.bias)
            y = y.view(n, gh, gw, -1).permute(0, 3, 1, 2)
            if isinstance(resize, nn.ConvTranspose2d):
                y = _conv(f"layer{i}.resize", F.conv_transpose2d, y, resize.weight, resize.bias,
                          stride=resize.stride)
            elif isinstance(resize, nn.Conv2d):
                y = _conv(f"layer{i}.resize", F.conv2d, y, resize.weight, resize.bias, stride=2, padding=1)
            if self.cfg.temporal and i >= 3:
                y = self._temporal(i - 3, f"layer{i}", y, streams)
            rn = getattr(self.scratch, f"layer{i}_rn")
            out.append(_head_conv(f"layer{i}_rn", F.conv2d, y, rn.weight, padding=1))
        return out

    def forward(self, hooks: List[torch.Tensor], streams: int = 1) -> torch.Tensor:
        s = self.scratch
        with span("dpt.reassemble"):
            l1, l2, l3, l4 = self._reassemble(hooks, streams)
        with span("dpt.fusion", "refinenet4"):
            path = s.refinenet4(l4, None, l3.shape[2:])
        if self.cfg.temporal:
            path = self._temporal(2, "path4", path, streams)
        with span("dpt.fusion", "refinenet3"):
            path = s.refinenet3(path, l3, l2.shape[2:])
        if self.cfg.temporal:
            path = self._temporal(3, "path3", path, streams)
        with span("dpt.fusion", "refinenet2"):
            path = s.refinenet2(path, l2, l1.shape[2:])
        with span("dpt.fusion", "refinenet1"):
            path = s.refinenet1(path, l1, (2 * l1.shape[2], 2 * l1.shape[3]))
        with span("dpt.output"):
            p = self.cfg.patch_size
            gh, gw = self.cfg.grid
            y = _conv("output_conv1", F.conv2d, path, s.output_conv1.weight, s.output_conv1.bias, padding=1)
            y = bilinear_resize(y, (gh * p, gw * p))
            y = _bias_relu(_head_conv("output_conv2.0", F.conv2d, y, s.output_conv2[0].weight, padding=1),
                           s.output_scale, s.output_shift)
            y = _conv("output_conv2.2", F.conv2d, y, s.output_conv2[2].weight, s.output_conv2[2].bias)
            return y.float()


class DPT(nn.Module):
    """Eval-mode DPT on NCHW input; returns (N, 1, H, W) float32 logits,
    as ``UNet`` does. Inference only: run it without autograd recording
    (``conv_epilogue`` has no gradient). ``attention_calls`` counts the SDPA calls of every
    forward by the backend's name (``CUDNN_ATTENTION``, ...), and
    ``temporal_attention_calls`` the temporal modules' SDPA calls so.
    With the temporal head, ``forward(x, streams)`` takes x's rows as
    ``streams`` runs of frames in time order (the module's docstring)."""

    attention_calls: Dict[str, int] = collections.Counter()
    temporal_attention_calls: Dict[str, int] = collections.Counter()

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = torch.float32
        self.pretrained = DinoEncoder(cfg)
        self.depth_head = DPTHead(cfg)
        self.eval()

    def fold_bias(self) -> None:
        """Recompute the epilogues' float32 vectors from the conv biases;
        ``load_state_dict`` and ``to_compute_dtype`` call it."""
        for m in self.modules():
            if isinstance(m, (ResidualConvUnit, Scratch)):
                m.fold_bias()

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        out = super().load_state_dict(state_dict, strict=strict, assign=assign)
        self.fold_bias()
        return out

    def to_compute_dtype(self, dtype: torch.dtype) -> "DPT":
        """Every weight in ``dtype``; the epilogues' shifts are the biases
        rounded to it, held in float32."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
        self.to(dtype)
        self.fold_bias()
        self.compute_dtype = dtype
        return self

    def forward(self, x: torch.Tensor, streams: int = 1) -> torch.Tensor:
        if self.cfg.temporal and x.shape[0] % streams:
            raise ValueError(f"{x.shape[0]} frames do not make {streams} streams of equal length")
        dtype = self.compute_dtype
        with _no_tf32(dtype):
            with span("dpt.encoder"):
                hooks = self.pretrained(x.to(dtype))
            with span("dpt.head"):
                return self.depth_head(hooks, streams)


def dpt_state_shapes(cfg: DPTConfig) -> Dict[str, Tuple[int, ...]]:
    """Shape of every state-dict entry of ``DPT(cfg)``, built on the meta
    device."""
    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in DPT(cfg).state_dict().items()}
