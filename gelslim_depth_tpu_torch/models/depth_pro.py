"""Depth Pro for tactile depth, eval forward: two DINOv2 ViT-L/16 encoders
over a pyramid of overlapping tiles and a multi-resolution conv decoder,
laid out as Apple's published model lays them out
(https://github.com/apple/ml-depth-pro: ``src/depth_pro/depth_pro.py``,
``network/encoder.py``, ``network/decoder.py``, ``network/vit_factory.py``,
preset ``dinov2l16_384``; Bochkovskii et al., arXiv:2410.02073).

``x`` is (N, 3, S, S) with S = 4 T, T the encoders' tile (384 published,
so S = 1536). Both ViTs are ``models/dpt.py``'s ``DinoEncoder`` at patch p
(16) on T x T tiles, a g x g grid, g = T / p (24): ``embed_dim`` wide,
``depth`` blocks of ``num_heads`` heads, MLP ``mlp_ratio`` x wide with
erf GELU, qkv bias, LayerScale, LayerNorm eps 1e-6, the position table at
g x g + 1; timm's ``forward_features``, final norm included.

1. Pyramid: ``x1 = F.interpolate(x, scale_factor=0.5, mode="bilinear",
   align_corners=False)`` (2T), ``x2`` the same at 0.25 (T).
2. Split: x into 5 x 5 tiles of T at stride 3T/4 (overlap 0.25), x1 into
   3 x 3 at stride T/2 (overlap 0.5), x2 one tile; row-major, batched
   tile-major (row ``t N + n``): 35 N sequences.
3. Patch encoder: one ViT on the 35 N tiles, its final normed tokens, the
   class token dropped, each a g x g map; besides, the raw (un-normed)
   outputs of blocks ``hooks`` (5 and 11) on the 25 N tiles of x.
4. Merge: each 5 x 5 group (the two hooks and x's tiles) cropped by
   ``merge_padding[0]`` cells (3) on each interior side and concatenated,
   5 g - 8 pad = 4 g (96) a side; the 3 x 3 group by ``merge_padding[1]``
   (6), 3 g - 4 pad = 2 g (48); x2's map stays g x g.
5. Image encoder: a second ViT of its own weights on x2, ``g`` (g x g).
6. Projection-upsample blocks, each a 1x1 conv without bias, then k
   transposed convs k2 s2 without bias: hook 5 ``D -> dims_encoder[0]``
   then ``decoder_features`` (k = 3, 32 g); hook 11 ``D ->
   dims_encoder[0]`` (k = 2, 16 g); x's map ``D -> dims_encoder[1]`` (k =
   1, 8 g); x1's ``-> dims_encoder[2]`` (k = 1, 4 g); x2's ``->
   dims_encoder[3]`` (k = 1, 2 g). ``g`` through a transposed conv ``D ->
   dims_encoder[3]`` with bias, then a 1x1 conv with bias on ``cat(x2's
   map, g)``.
7. Decoder (``MultiresConvDecoder``, ``decoder_features`` F wide): the
   five levels from 32 g down to 2 g each into F channels, level 0 by the
   identity, levels 1-4 by 3x3 convs without bias; ``f =
   fusion4(conv4(e4))``, then ``f = fusion_i(f, conv_i(e_i))`` for i = 3
   ... 0. A fusion block: ``x = x0 + RCU1(x1)`` (where x1 is given), ``x =
   RCU2(x)``, at levels 1-4 a transposed conv F -> F (k2 s2, no bias), a
   1x1 conv with bias; ``RCU(x) = x + conv3(relu(conv3(relu(x))))``, 3x3
   convs with bias: the DPT's ``ResidualConvUnit`` and
   ``FeatureFusionBlock`` (``deconv=True``).
8. Head: a 3x3 conv F -> F/2 at 32 g, a transposed conv F/2 -> F/2 (k2 s2,
   bias) to 64 g = S, a 3x3 conv F/2 -> ``head_features`` (32), ReLU, a
   1x1 conv to one channel.

Departures, each the serving system's (the benchmark configuration's
``assumed`` and ``reduced``):
- no FOV network (``use_fov_head`` false): it only estimates the focal
  length, which the sensor fixes; the published model's ReLU after the
  head's last 1x1 conv is left out, and its canonical inverse depth is
  read as the system's normalized depth (no metric conversion);
- state-dict names are the published module's (``encoder.patch_encoder
  .blocks.{i}.attn.qkv``, ``encoder.upsample_latent0.{0..3}``,
  ``decoder.convs.{1..4}``, ``decoder.fusions.{i}.deconv``, ``head.{0,1,2,
  4}``) but for what this model shares with the DPT: each encoder's
  ``mask_token`` (DINOv2's, which timm's model lacks) and the fusion
  blocks' residual units, ``resConfUnit{1,2}.conv{1,2}`` for the published
  ``resnet{1,2}.residual.{1,3}``.

Compute dtype (``to_compute_dtype``) as the DPT's: every weight in it; the
pyramid in float32 on the float32 input, each level rounded once as it is
cut into tiles; the encoders as ``DinoEncoder`` runs them
(``residual_layer_norm``, cuDNN's SDPA for bfloat16 on CUDA); the 1x1
projections as matrix products on the merged tokens, whose (N, h, w, C)
layout is channels-last NCHW, so the decoder runs channels-last; the
convs' biases as the DPT head's (``models/dpt.py``): where a bias feeds a
ReLU (each residual unit's first conv, the head's 3x3 to
``head_features``) the conv without it and ``conv_epilogue`` with the
ReLU; on CUDA every other conv with a bias without it too, one
``conv_epilogue`` adding it (``_conv``), with the unit's skip add at each
residual unit's second conv, alone at the rest (``upsample_lowres``, each
fusion block's ``out_conv``, the head's 3x3, transposed conv and last
1x1). float32 runs with TF32 off.

Spans (``utils.profiling.span``): ``depth_pro.pyramid`` (the two
downsamples and the split), ``depth_pro.patch_encoder`` and
``depth_pro.image_encoder`` (each holding its blocks' ``dpt.block``
spans), ``depth_pro.merge``, ``depth_pro.upsample`` (the six blocks and
``fuse_lowres``), ``depth_pro.fusion`` (sites ``level4`` ... ``level0``:
each level's conv and fusion block), ``depth_pro.head``; inside those
three, each conv, transposed conv and 1x1 matrix product is a
``head.conv`` span of its own (``models/dpt.py::_head_conv``; its
``conv_epilogue``, the ReLUs, adds, concat and permutes outside), 50 a
call, whose sites joined to their level's name the ops of
``benchmark/yardstick_depth_pro.decoder_ops``: ``latent0.proj``,
``latent0.up0`` ... ``up2``, ``latent1.proj``, ``latent1.up0``,
``latent1.up1``, ``x{0,1,2}.proj``, ``x{0,1,2}.up``, ``lowres``,
``fuse_lowres`` in ``depth_pro.upsample``; ``conv`` (levels 1-4),
``unit{1,2}.conv{1,2}``, ``deconv`` (levels 1-4) and ``out`` in each
``depth_pro.fusion``; ``head.0``, ``head.1``, ``head.2``, ``head.4`` in
``depth_pro.head``.
``DepthPro.tiles`` counts the encoder sequences of every forward;
``DPT.attention_calls`` the SDPA calls by backend.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gelslim_depth_tpu_torch.models.dpt import (
    DinoEncoder, DPTConfig, FeatureFusionBlock, ResidualConvUnit, _bias_relu, _conv, _epilogue_vectors, _head_conv,
    _no_tf32,
)
from gelslim_depth_tpu_torch.utils.profiling import span

# (tiles a side, overlap) of the pyramid's two split levels: x's, x1's
SPLITS = ((5, 0.25), (3, 0.5))


@dataclasses.dataclass(frozen=True)
class DepthProConfig:
    """Depth Pro's ``dinov2l16_384`` by default. ``image_size`` is the
    network input's (S, S), four tiles a side;
    ``GelslimConfig.depth_pro_config()`` sets it from the input size.
    ``merge_padding`` is the cells cropped on each interior side of a tile
    when the 5 x 5 and the 3 x 3 groups are merged: the published 3 and 6
    at the 24-grid, g / 8 and g / 4 at a g-grid."""

    patch_size: int = 16
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-6
    hooks: Tuple[int, ...] = (5, 11)
    merge_padding: Tuple[int, int] = (3, 6)
    dims_encoder: Tuple[int, ...] = (256, 512, 1024, 1024)
    decoder_features: int = 256
    head_features: int = 32
    image_size: Optional[Tuple[int, int]] = None

    @classmethod
    def from_dict(cls, d: dict) -> "DepthProConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in names})

    @property
    def tile(self) -> int:
        """The encoders' tile side, a quarter of the input's."""
        if self.image_size is None:
            raise ValueError("DepthProConfig.image_size is not set")
        h, w = self.image_size
        if h != w or h % 4 or (h // 4) % self.patch_size:
            raise ValueError(f"the input {h}x{w} is not square of four tiles a side, each a multiple of "
                             f"the patch {self.patch_size}")
        return h // 4

    @property
    def grid(self) -> int:
        return self.tile // self.patch_size

    def vit(self) -> DPTConfig:
        """Either encoder's configuration: its hook the last block, through
        the final norm."""
        return DPTConfig(patch_size=self.patch_size, embed_dim=self.embed_dim, depth=self.depth,
                         num_heads=self.num_heads, mlp_ratio=self.mlp_ratio, layer_norm_eps=self.layer_norm_eps,
                         hooks=(self.depth - 1,), image_size=(self.tile, self.tile))


def split_grid(size: int, tile: int, overlap: float) -> Tuple[int, int]:
    """(tiles a side, stride) of the published split of a side of ``size``
    into tiles of ``tile`` overlapping by ``overlap``."""
    stride = int(tile * (1 - overlap))
    steps = int(math.ceil((size - tile) / stride)) + 1
    if (steps - 1) * stride + tile != size:
        raise ValueError(f"tiles of {tile} at stride {stride} do not cover {size} exactly")
    return steps, stride


def split_into(out: torch.Tensor, x: torch.Tensor, tile: int, overlap: float) -> None:
    """x's (N, C, size, size) tiles into out, (steps^2 N, C, tile, tile),
    row-major and tile-major (row ``t N + n``), cast to out's dtype."""
    n, c, size = x.shape[0], x.shape[1], x.shape[-1]
    steps, stride = split_grid(size, tile, overlap)
    windows = x.unfold(2, tile, stride).unfold(3, tile, stride)  # (N, C, steps, steps, tile, tile)
    out.view(steps, steps, n, c, tile, tile).copy_(windows.permute(2, 3, 0, 1, 4, 5))


def merge(maps: torch.Tensor, n: int, steps: int, padding: int) -> torch.Tensor:
    """The published merge of (steps^2 N, g, g, C) tile maps, tile-major:
    each tile cropped by ``padding`` cells on each side that meets another
    tile, the tiles concatenated row-major; (N, H, W, C)."""
    g = maps.shape[1]
    tiles = maps.view(steps, steps, n, g, g, maps.shape[-1])

    def cut(k):
        return slice(padding if k else 0, g - padding if k < steps - 1 else g)

    rows = [torch.cat([tiles[j, i, :, cut(j), cut(i)] for i in range(steps)], dim=2) for j in range(steps)]
    return torch.cat(rows, dim=1)


def _upsample_block(dim_in: int, dim_out: int, layers: int, dim_int: Optional[int] = None) -> nn.Sequential:
    """The published ``_create_project_upsample_block``: a 1x1 conv without
    bias to ``dim_int``, then ``layers`` transposed convs k2 s2 without bias
    to ``dim_out``."""
    dim_int = dim_out if dim_int is None else dim_int
    return nn.Sequential(nn.Conv2d(dim_in, dim_int, 1, bias=False), *(
        nn.ConvTranspose2d(dim_int if i == 0 else dim_out, dim_out, 2, stride=2, bias=False) for i in range(layers)))


def _project_upsample(block: nn.Sequential, t: torch.Tensor, site: str) -> torch.Tensor:
    """An upsample block on (N, h, w, D) tokens: the 1x1 conv as a matrix
    product, whose (N, h, w, C) output is channels-last NCHW, then the
    transposed convs; (N, C, H, W) channels-last. Its ``head.conv`` sites:
    ``<site>.proj``, then ``<site>.up`` for one transposed conv, else
    ``<site>.up0``, ``<site>.up1``, ..."""
    y = _head_conv(f"{site}.proj", F.linear, t, block[0].weight.flatten(1)).permute(0, 3, 1, 2)
    ups = block[1:]
    for j, deconv in enumerate(ups):
        y = _head_conv(f"{site}.up" if len(ups) == 1 else f"{site}.up{j}", F.conv_transpose2d, y, deconv.weight,
                       stride=2)
    return y


class DepthProEncoder(nn.Module):
    def __init__(self, cfg: DepthProConfig):
        super().__init__()
        d, dims, f = cfg.embed_dim, cfg.dims_encoder, cfg.decoder_features
        self.patch_encoder = DinoEncoder(cfg.vit())
        self.image_encoder = DinoEncoder(cfg.vit())
        self.upsample_latent0 = _upsample_block(d, f, 3, dim_int=dims[0])
        self.upsample_latent1 = _upsample_block(d, dims[0], 2)
        self.upsample0 = _upsample_block(d, dims[1], 1)
        self.upsample1 = _upsample_block(d, dims[2], 1)
        self.upsample2 = _upsample_block(d, dims[3], 1)
        self.upsample_lowres = nn.ConvTranspose2d(d, dims[3], 2, stride=2)
        self.fuse_lowres = nn.Conv2d(2 * dims[3], dims[3], 1)


class MultiresConvDecoder(nn.Module):
    def __init__(self, cfg: DepthProConfig):
        super().__init__()
        f = cfg.decoder_features
        dims = (f,) + tuple(cfg.dims_encoder)
        self.convs = nn.ModuleList([nn.Identity()] + [nn.Conv2d(c, f, 3, padding=1, bias=False) for c in dims[1:]])
        self.fusions = nn.ModuleList(FeatureFusionBlock(f, deconv=i != 0) for i in range(len(dims)))


class DepthPro(nn.Module):
    """Eval-mode Depth Pro on NCHW input of ``cfg.image_size``; returns
    (N, 1, S, S) float32 logits, as ``DPT`` does. Inference only: run it
    without autograd recording (``conv_epilogue`` has no gradient).
    ``tiles`` counts the encoder sequences (36 an image) of every forward;
    ``merge`` is the merge of step 4, an attribute that a control may
    replace."""

    tiles: int = 0

    def __init__(self, cfg: DepthProConfig):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = torch.float32
        self.merge = merge
        self.encoder = DepthProEncoder(cfg)
        self.decoder = MultiresConvDecoder(cfg)
        f = cfg.decoder_features
        self.head = nn.Sequential(
            nn.Conv2d(f, f // 2, 3, padding=1), nn.ConvTranspose2d(f // 2, f // 2, 2, stride=2),
            nn.Conv2d(f // 2, cfg.head_features, 3, padding=1), nn.ReLU(), nn.Conv2d(cfg.head_features, 1, 1),
        )
        self.fold_bias()
        self.eval()

    def fold_bias(self) -> None:
        """Recompute the epilogues' float32 vectors from the conv biases;
        ``load_state_dict`` and ``to_compute_dtype`` call it."""
        for m in self.modules():
            if isinstance(m, ResidualConvUnit):
                m.fold_bias()
        _epilogue_vectors(self, "head_out", self.head[2])

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        out = super().load_state_dict(state_dict, strict=strict, assign=assign)
        self.fold_bias()
        return out

    def to_compute_dtype(self, dtype: torch.dtype) -> "DepthPro":
        """Every weight in ``dtype``; the epilogues' shifts are the biases
        rounded to it, held in float32."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
        self.to(dtype)
        self.fold_bias()
        self.compute_dtype = dtype
        return self

    def _tiles(self, x: torch.Tensor) -> torch.Tensor:
        """Steps 1-2: the (35 N, 3, T, T) tiles of the pyramid, x's first,
        then x1's, then x2, in the compute dtype."""
        n, c = x.shape[:2]
        t = self.cfg.tile
        x = x.float()
        x1 = F.interpolate(x, scale_factor=0.5, mode="bilinear", align_corners=False)
        x2 = F.interpolate(x, scale_factor=0.25, mode="bilinear", align_corners=False)
        counts = [steps * steps * n for steps, _ in SPLITS]
        tiles = torch.empty((sum(counts) + n, c, t, t), dtype=self.compute_dtype, device=x.device)
        split_into(tiles[:counts[0]], x, t, SPLITS[0][1])
        split_into(tiles[counts[0]:-n], x1, t, SPLITS[1][1])
        tiles[-n:].copy_(x2)
        return tiles

    def _encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Steps 1-6: the decoder's five inputs, (N, C, H, W) channels-last,
        from the highest resolution down."""
        cfg, enc = self.cfg, self.encoder
        n, g = x.shape[0], cfg.grid
        (s0, _), (s1, _) = SPLITS
        with span("depth_pro.pyramid"):
            tiles = self._tiles(x)
        DepthPro.tiles += tiles.shape[0] + n
        with span("depth_pro.patch_encoder"):
            final, hook0, hook1 = enc.patch_encoder(tiles, raw=cfg.hooks)
        with span("depth_pro.image_encoder"):
            (glob,) = enc.image_encoder(tiles[-n:])
        del tiles
        with span("depth_pro.merge"):
            grid = (g, g, cfg.embed_dim)
            a, b = s0 * s0 * n, s1 * s1 * n
            p0, p1 = cfg.merge_padding
            latent0 = self.merge(hook0[:a].view(a, *grid), n, s0, p0)
            latent1 = self.merge(hook1[:a].view(a, *grid), n, s0, p0)
            del hook0, hook1
            x0 = self.merge(final[:a].view(a, *grid), n, s0, p0)
            x1 = self.merge(final[a:a + b].view(b, *grid), n, s1, p1)
            x2 = final[a + b:].view(n, *grid)
            del final
        with span("depth_pro.upsample"):
            out = [_project_upsample(enc.upsample_latent0, latent0, "latent0"),
                   _project_upsample(enc.upsample_latent1, latent1, "latent1"),
                   _project_upsample(enc.upsample0, x0, "x0"), _project_upsample(enc.upsample1, x1, "x1")]
            x2 = _project_upsample(enc.upsample2, x2, "x2")
            lo = enc.upsample_lowres
            glob = _conv("lowres", F.conv_transpose2d, glob.view(n, *grid).permute(0, 3, 1, 2), lo.weight, lo.bias,
                         stride=2)
            both = torch.cat([x2.permute(0, 2, 3, 1), glob.permute(0, 2, 3, 1)], dim=-1)
            fuse = enc.fuse_lowres
            out.append(_head_conv("fuse_lowres", F.linear, both, fuse.weight.flatten(1), fuse.bias).permute(0, 3, 1, 2))
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dec = self.decoder
        with _no_tf32(self.compute_dtype):
            levels = self._encode(x)
            f = None
            for i in range(len(levels) - 1, -1, -1):
                with span("depth_pro.fusion", f"level{i}"):
                    e, conv = levels.pop(), dec.convs[i]
                    if isinstance(conv, nn.Conv2d):
                        e = _head_conv("conv", F.conv2d, e, conv.weight, padding=1)
                    f = dec.fusions[i](e, None) if f is None else dec.fusions[i](f, e)
                    del e
            with span("depth_pro.head"):
                h = self.head
                y = _conv("head.0", F.conv2d, f, h[0].weight, h[0].bias, padding=1)
                del f
                y = _conv("head.1", F.conv_transpose2d, y, h[1].weight, h[1].bias, stride=2)
                y = _bias_relu(_head_conv("head.2", F.conv2d, y, h[2].weight, padding=1), self.head_out_scale,
                               self.head_out_shift)
                return _conv("head.4", F.conv2d, y, h[4].weight, h[4].bias).float()


def depth_pro_state_shapes(cfg: DepthProConfig):
    """Shape of every state-dict entry of ``DepthPro(cfg)``, built on the
    meta device."""
    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in DepthPro(cfg).state_dict().items()}
