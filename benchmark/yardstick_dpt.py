"""The dense-prediction transformer configuration's arithmetic: the work a
serving call must do, counted from the configuration's shapes alone
(``benchmark/configs/dpt_*.json``), whatever implements the model. FLOPs
count 2 a multiply-add; bytes count each input read once and each output
written once, at the compute dtype's 2 bytes, a weight once a call.

- ``image_flops``: the forward of one finger image: the patch embedding,
  the blocks' matrix products and attention core (``4 T^2 D``: q k^T and
  the probabilities times v; the softmax is not counted), the head's
  projections, resizes, ``layer{i}_rn`` convs, fusion blocks and output
  convs.
- ``block_ops``: the ten ops of one encoder block over a call's images,
  each with its FLOPs and bytes: LayerNorm, qkv, the attention core
  (q, k and v read, the output written), proj, LayerScale + residual,
  LayerNorm, fc1, GELU, fc2, LayerScale + residual. An elementwise op's
  FLOPs are nominal (its bytes bound it).
- ``vit_bound_ms``: the blocks' least time, each op the larger of its
  FLOPs at the bf16 peak and its bytes at the bandwidth, summed over the
  ops and the blocks; ``attention_bound_ms`` the same of the attention
  cores alone.
"""

from __future__ import annotations

from typing import List, NamedTuple

from benchmark.reference.dpt import grid
from benchmark.yardstick import Peaks

ELEM_BYTES = 2  # bfloat16


class Op(NamedTuple):
    name: str
    flops: float
    bytes: float


def tokens(cfg: dict) -> int:
    gh, gw = grid(cfg)
    return 1 + gh * gw


def block_ops(cfg: dict, images: int) -> List[Op]:
    """One encoder block's ops over ``images`` images."""
    d = cfg["dpt"]
    D, hidden = d["embed_dim"], d["mlp_ratio"] * d["embed_dim"]
    t = tokens(cfg)
    m = images * t
    b = ELEM_BYTES

    def linear(name, cin, cout):
        return Op(name, 2.0 * m * cin * cout, b * (m * cin + cin * cout + cout + m * cout))

    def norm(name):
        return Op(name, 8.0 * m * D, b * (2 * m * D + 2 * D))

    def scaled_add(name):
        return Op(name, 2.0 * m * D, b * (3 * m * D + D))

    return [
        norm("norm1"), linear("qkv", D, 3 * D),
        Op("attention", 4.0 * images * t * t * D, b * 4 * m * D),
        linear("proj", D, D), scaled_add("ls1"), norm("norm2"), linear("fc1", D, hidden),
        Op("gelu", 8.0 * m * hidden, b * 2 * m * hidden), linear("fc2", hidden, D), scaled_add("ls2"),
    ]


def op_ms(op: Op, peaks: Peaks) -> float:
    return 1e3 * max(op.flops / peaks.bf16_flops, op.bytes / peaks.bytes_per_s)


def vit_bound_ms(cfg: dict, images: int, peaks: Peaks) -> float:
    return cfg["dpt"]["depth"] * sum(op_ms(op, peaks) for op in block_ops(cfg, images))


def attention_bound_ms(cfg: dict, images: int, peaks: Peaks) -> float:
    att = next(op for op in block_ops(cfg, images) if op.name == "attention")
    return cfg["dpt"]["depth"] * op_ms(att, peaks)


def head_flops(cfg: dict) -> dict:
    """The head's FLOPs of one image, by part: reassemble (projections and
    resizes), ``rn`` convs, fusion blocks, output convs."""
    d = cfg["dpt"]
    D, oc, f, hf, p = d["embed_dim"], d["out_channels"], d["features"], d["head_features"], d["patch_size"]
    gh, gw = grid(cfg)
    g = gh * gw
    sizes = [(4 * gh, 4 * gw), (2 * gh, 2 * gw), (gh, gw), ((gh + 1) // 2, (gw + 1) // 2)]
    reassemble = sum(2.0 * g * D * c for c in oc)
    reassemble += 2.0 * oc[0] * oc[0] * 16 * g + 2.0 * oc[1] * oc[1] * 4 * g
    reassemble += 2.0 * 9 * oc[3] * oc[3] * sizes[3][0] * sizes[3][1]
    rn = sum(2.0 * 9 * c * f * h * w for c, (h, w) in zip(oc, sizes))
    unit = 2 * 2.0 * 9 * f * f  # a residual conv unit, a pixel

    def hw(s):
        return s[0] * s[1]

    fusion = unit * hw(sizes[3]) + 2.0 * f * f * hw(sizes[2])  # refinenet4: one unit, out at l3's size
    for i, out in ((2, sizes[1]), (1, sizes[0]), (0, (8 * gh, 8 * gw))):  # refinenet3, 2, 1
        fusion += 2 * unit * hw(sizes[i]) + 2.0 * f * f * hw(out)
    output = 2.0 * 9 * f * (f // 2) * 64 * g + 2.0 * 9 * (f // 2) * hf * g * p * p + 2.0 * hf * g * p * p
    return {"reassemble": reassemble, "rn": rn, "fusion": fusion, "output": output}


def encoder_flops(cfg: dict) -> dict:
    """The encoder's FLOPs of one image: the patch embedding, the blocks'
    matrix products, their attention cores."""
    d = cfg["dpt"]
    ops = block_ops(cfg, 1)
    gh, gw = grid(cfg)
    gemm = sum(op.flops for op in ops if op.name in ("qkv", "proj", "fc1", "fc2"))
    return {"patch_embed": 2.0 * gh * gw * d["embed_dim"] * 3 * d["patch_size"] ** 2,
            "gemm": d["depth"] * gemm,
            "attention": d["depth"] * next(op.flops for op in ops if op.name == "attention")}


def image_flops(cfg: dict) -> float:
    return sum(encoder_flops(cfg).values()) + sum(head_flops(cfg).values())


def call_flops(cfg: dict, dual_frames: int) -> float:
    """Model FLOPs of a serving call: two finger images a dual frame."""
    return 2.0 * dual_frames * image_flops(cfg)
