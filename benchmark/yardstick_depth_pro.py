"""Depth Pro's arithmetic: the work a serving call must do, counted from
the configuration's shapes alone (``benchmark/configs/depth_pro_*.json``),
whatever implements the model, as ``yardstick_dpt.py`` counts the DPT's.
FLOPs count 2 a multiply-add; bytes count each input read once and each
output written once, at the compute dtype's 2 bytes, a weight once a call.

- The encoders: 36 ViT passes a finger image (``SEQUENCES``: 25 tiles of
  the input, 9 of its half, the quarter-size image through the patch
  encoder and again through the image encoder), each one of
  ``yardstick_dpt``'s at the tile's grid (``vit_config``): the patch
  embedding, the blocks' matrix products, their attention cores.
- ``upsample_ops``, ``fusion_ops``, ``head_ops``: the ops of the
  projection-upsample blocks (their 1x1 convs and transposed convs k2 s2,
  ``upsample_lowres``, ``fuse_lowres``), of the decoder's five levels (the
  3x3 conv into the decoder's width; each residual conv unit's ReLU, 3x3,
  bias and ReLU, 3x3 and residual add; the fusion's add; the transposed
  conv; the 1x1) and of the head (3x3, transposed conv, 3x3, bias and
  ReLU, 1x1) over a call's images, each with its FLOPs and bytes. An
  elementwise op's FLOPs are nominal (its bytes bound it). The concat
  before ``fuse_lowres`` is no op of its own: the 1x1 conv can read its
  two inputs where they lie.
- ``call_flops``: the model's FLOPs of a call (the elementwise ops'
  nominal FLOPs left out); ``vit_bound_ms``: the 36 passes' blocks'
  least time, ``yardstick_dpt.vit_bound_ms`` at the tile's grid;
  ``decoder_bound_ms``: the upsample blocks', decoder's and head's least
  time, each op the larger of its FLOPs at the bf16 peak and its bytes at
  the bandwidth, summed.
"""

from __future__ import annotations

from typing import List

from benchmark import yardstick_dpt
from benchmark.reference.depth_pro import SPLITS, grid, tile
from benchmark.yardstick import Peaks
from benchmark.yardstick_dpt import ELEM_BYTES, Op, op_ms

SEQUENCES = sum(steps * steps for steps, _ in SPLITS) + 2  # ViT passes a finger image
ELEMENTWISE = ("relu", "bias_relu", "add")


def vit_config(cfg: dict) -> dict:
    """Either encoder as ``yardstick_dpt`` reads a DPT configuration: its
    widths and the tile as its input."""
    d = cfg["depth_pro"]
    t = tile(cfg)
    return {"dpt": {k: d[k] for k in ("patch_size", "embed_dim", "depth", "num_heads", "mlp_ratio")},
            "input_tactile_image_size": [t, t]}


def encoder_flops(cfg: dict) -> float:
    """The 36 ViT passes' FLOPs of one finger image."""
    return SEQUENCES * sum(yardstick_dpt.encoder_flops(vit_config(cfg)).values())


def _conv(name: str, images: int, side: int, cin: int, cout: int, k: int = 1, bias: bool = True) -> Op:
    """A stride-1 same-size conv at ``side`` x ``side``."""
    m = images * side * side
    return Op(name, 2.0 * m * cin * cout * k * k,
              ELEM_BYTES * (m * cin + cin * cout * k * k + (cout if bias else 0) + m * cout))


def _deconv(name: str, images: int, side: int, cin: int, cout: int, bias: bool = False) -> Op:
    """A transposed conv k2 s2 from ``side`` x ``side`` to twice it."""
    m = images * side * side
    return Op(name, 2.0 * m * cin * cout * 4, ELEM_BYTES * (m * cin + 4 * cin * cout + (cout if bias else 0)
                                                            + 4 * m * cout))


def _elementwise(name: str, images: int, side: int, c: int, inputs: int) -> Op:
    m = images * side * side * c
    return Op(name, 1.0 * m, ELEM_BYTES * (inputs + 1) * m)


def upsample_ops(cfg: dict, images: int) -> List[Op]:
    d = cfg["depth_pro"]
    D, dims, f, g = d["embed_dim"], d["dims_encoder"], d["decoder_features"], grid(cfg)
    ops = [_conv("latent0.proj", images, 4 * g, D, dims[0], bias=False),
           _deconv("latent0.up0", images, 4 * g, dims[0], f), _deconv("latent0.up1", images, 8 * g, f, f),
           _deconv("latent0.up2", images, 16 * g, f, f),
           _conv("latent1.proj", images, 4 * g, D, dims[0], bias=False),
           _deconv("latent1.up0", images, 4 * g, dims[0], dims[0]),
           _deconv("latent1.up1", images, 8 * g, dims[0], dims[0])]
    for i, side in enumerate((4 * g, 2 * g, g)):
        ops += [_conv(f"x{i}.proj", images, side, D, dims[i + 1], bias=False),
                _deconv(f"x{i}.up", images, side, dims[i + 1], dims[i + 1])]
    return ops + [_deconv("lowres", images, g, D, dims[3], bias=True),
                  _conv("fuse_lowres", images, 2 * g, 2 * dims[3], dims[3])]


def _unit(name: str, images: int, side: int, f: int) -> List[Op]:
    return [_elementwise(f"{name}.relu", images, side, f, 1), _conv(f"{name}.conv1", images, side, f, f, 3, False),
            _elementwise(f"{name}.bias_relu", images, side, f, 1), _conv(f"{name}.conv2", images, side, f, f, 3),
            _elementwise(f"{name}.add", images, side, f, 2)]


def fusion_ops(cfg: dict, images: int) -> List[Op]:
    """The decoder's five levels, level 4 (2 g) first."""
    d = cfg["depth_pro"]
    f, g = d["decoder_features"], grid(cfg)
    widths = (f,) + tuple(d["dims_encoder"])
    ops: List[Op] = []
    for i in range(4, -1, -1):
        side = 32 * g >> i
        if i:
            ops.append(_conv(f"level{i}.conv", images, side, widths[i], f, 3, False))
        if i < 4:
            ops += _unit(f"level{i}.unit1", images, side, f) + [_elementwise(f"level{i}.add", images, side, f, 2)]
        ops += _unit(f"level{i}.unit2", images, side, f)
        if i:
            ops.append(_deconv(f"level{i}.deconv", images, side, f, f))
        ops.append(_conv(f"level{i}.out", images, 2 * side if i else side, f, f))
    return ops


def head_ops(cfg: dict, images: int) -> List[Op]:
    d = cfg["depth_pro"]
    f, hf, side = d["decoder_features"], d["head_features"], 32 * grid(cfg)
    return [_conv("head.0", images, side, f, f // 2, 3), _deconv("head.1", images, side, f // 2, f // 2, bias=True),
            _conv("head.2", images, 2 * side, f // 2, hf, 3, False),
            _elementwise("head.bias_relu", images, 2 * side, hf, 1), _conv("head.4", images, 2 * side, hf, 1)]


def decoder_ops(cfg: dict, images: int) -> List[Op]:
    return upsample_ops(cfg, images) + fusion_ops(cfg, images) + head_ops(cfg, images)


def _model_flops(ops: List[Op]) -> float:
    return sum(op.flops for op in ops if op.name.rsplit(".", 1)[-1] not in ELEMENTWISE)


def image_flops(cfg: dict) -> dict:
    """One finger image's FLOPs, by part: the encoders, the upsample
    blocks, the decoder, the head."""
    return {"encoders": encoder_flops(cfg), "upsample": _model_flops(upsample_ops(cfg, 1)),
            "decoder": _model_flops(fusion_ops(cfg, 1)), "head": _model_flops(head_ops(cfg, 1))}


def call_flops(cfg: dict, dual_frames: int) -> float:
    """Model FLOPs of a serving call: two finger images a dual frame."""
    return 2.0 * dual_frames * sum(image_flops(cfg).values())


def vit_bound_ms(cfg: dict, images: int, peaks: Peaks) -> float:
    return yardstick_dpt.vit_bound_ms(vit_config(cfg), SEQUENCES * images, peaks)


def decoder_bound_ms(cfg: dict, images: int, peaks: Peaks) -> float:
    return sum(op_ms(op, peaks) for op in decoder_ops(cfg, images))
