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
LayerScale and residual add as one ``addcmul``. A head conv whose bias
feeds a ReLU (the first conv of each residual unit, the
``head_features``-wide output conv) runs without its bias, and
``conv_epilogue``'s BatchNorm form finishes it (scale 1, shift the bias
in float32, ``relu``), rounded once. The head runs channels-last: the
tokens already are. Its five bilinear resizes (``align_corners=True``)
are ``bilinear_resize``, one hand-written kernel a resize on the card,
bit for bit the library's ``F.interpolate``. float32 runs with TF32 off.

Spans (``utils.profiling.span``): ``dpt.encoder`` (patch embedding, the
blocks, the hooks' norm), a ``dpt.block`` a block (site its index)
holding ``dpt.attention`` (the head split, the SDPA call, the merge) and
``dpt.mlp`` (fc1, GELU, fc2); ``dpt.head`` holding ``dpt.reassemble``
(projections, resizes, ``layer{i}_rn``), ``dpt.fusion`` (sites
``refinenet4`` ... ``refinenet1``) and ``dpt.output``.
``DPT.attention_calls`` counts SDPA calls by the backend pinned.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from gelslim_depth_tpu_torch.ops.kernels.bilinear_resize import bilinear_resize
from gelslim_depth_tpu_torch.ops.kernels.conv_epilogue import conv_epilogue
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
    image_size: Optional[Tuple[int, int]] = None

    @classmethod
    def from_dict(cls, d: dict) -> "DPTConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in names})

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

    def forward(self, x: torch.Tensor, backend) -> torch.Tensor:
        """x + ls1(attn(norm1(x))), then + ls2(mlp(norm2(x))); x (N, T, D)."""
        n, t, d = x.shape
        heads = self.attn.num_heads
        qkv = F.linear(self.norm1(x), self.attn.qkv.weight, self.attn.qkv.bias)
        with span("dpt.attention"):
            q, k, v = qkv.view(n, t, 3, heads, d // heads).permute(2, 0, 3, 1, 4).unbind(0)
            o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(n, t, d)
        DPT.attention_calls[backend.name] += 1
        x = torch.addcmul(x, F.linear(o, self.attn.proj.weight, self.attn.proj.bias), self.ls1.gamma)
        with span("dpt.mlp"):
            m = self.mlp(self.norm2(x))
        return torch.addcmul(x, m, self.ls2.gamma)


class DinoEncoder(nn.Module):
    """DINOv2's ``DinoVisionTransformer`` without registers, its position
    table at the configuration's grid; ``forward`` returns the hooked
    blocks' outputs through the final norm, class token dropped."""

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

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
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
        hooks = []
        with sdpa_kernel([backend]):
            for i, block in enumerate(self.blocks):
                with span("dpt.block", str(i)):
                    t = block(t, backend)
                if i in self.cfg.hooks:
                    hooks.append(self.norm(t[:, 1:]))
        return hooks


# ---------------------------------------------------------------------------
# head (DPT)
# ---------------------------------------------------------------------------

class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.fold_bias()

    def fold_bias(self) -> None:
        _epilogue_vectors(self, "conv1", self.conv1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _bias_relu(F.conv2d(torch.relu(x), self.conv1.weight, padding=1), self.conv1_scale, self.conv1_shift)
        return F.conv2d(h, self.conv2.weight, self.conv2.bias, padding=1) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor], size: Tuple[int, int]) -> torch.Tensor:
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = bilinear_resize(self.resConfUnit2(x), size)
        return F.conv2d(x, self.out_conv.weight, self.out_conv.bias)


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

    def _reassemble(self, hooks: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each hook's (N, T, D) tokens -> its ``layer{i}_rn`` map, (N,
        features, h, w) channels-last: the 1x1 projection as a matmul on the
        tokens, whose (N, h, w, C) layout is channels-last NCHW."""
        n = hooks[0].shape[0]
        gh, gw = self.cfg.grid
        out = []
        for i, (t, proj, resize) in enumerate(zip(hooks, self.projects, self.resize_layers), 1):
            y = F.linear(t, proj.weight.flatten(1), proj.bias).view(n, gh, gw, -1).permute(0, 3, 1, 2)
            if isinstance(resize, nn.ConvTranspose2d):
                y = F.conv_transpose2d(y, resize.weight, resize.bias, stride=resize.stride)
            elif isinstance(resize, nn.Conv2d):
                y = F.conv2d(y, resize.weight, resize.bias, stride=2, padding=1)
            out.append(F.conv2d(y, getattr(self.scratch, f"layer{i}_rn").weight, padding=1))
        return out

    def forward(self, hooks: List[torch.Tensor]) -> torch.Tensor:
        s = self.scratch
        with span("dpt.reassemble"):
            l1, l2, l3, l4 = self._reassemble(hooks)
        with span("dpt.fusion", "refinenet4"):
            path = s.refinenet4(l4, None, l3.shape[2:])
        with span("dpt.fusion", "refinenet3"):
            path = s.refinenet3(path, l3, l2.shape[2:])
        with span("dpt.fusion", "refinenet2"):
            path = s.refinenet2(path, l2, l1.shape[2:])
        with span("dpt.fusion", "refinenet1"):
            path = s.refinenet1(path, l1, (2 * l1.shape[2], 2 * l1.shape[3]))
        with span("dpt.output"):
            p = self.cfg.patch_size
            gh, gw = self.cfg.grid
            y = F.conv2d(path, s.output_conv1.weight, s.output_conv1.bias, padding=1)
            y = bilinear_resize(y, (gh * p, gw * p))
            y = _bias_relu(F.conv2d(y, s.output_conv2[0].weight, padding=1), s.output_scale, s.output_shift)
            y = F.conv2d(y, s.output_conv2[2].weight, s.output_conv2[2].bias)
            return y.float()


class DPT(nn.Module):
    """Eval-mode DPT on NCHW input; returns (N, 1, H, W) float32 logits,
    as ``UNet`` does. Inference only: run it without autograd recording
    (``conv_epilogue`` has no gradient). ``attention_calls`` counts the SDPA calls of every
    forward by the backend's name (``CUDNN_ATTENTION``, ...)."""

    attention_calls: Dict[str, int] = collections.Counter()

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        with _no_tf32(dtype):
            with span("dpt.encoder"):
                hooks = self.pretrained(x.to(dtype))
            with span("dpt.head"):
                return self.depth_head(hooks)


def dpt_state_shapes(cfg: DPTConfig) -> Dict[str, Tuple[int, ...]]:
    """Shape of every state-dict entry of ``DPT(cfg)``, built on the meta
    device."""
    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in DPT(cfg).state_dict().items()}
