"""The video depth configuration's arithmetic: the work a serving call must
do, counted from the configuration's shapes alone
(``benchmark/configs/vda_*.json``), whatever implements the model, as
``yardstick_dpt.py`` counts the DPT's. FLOPs count 2 a multiply-add;
bytes count each input read once and each output written once, at the
compute dtype's 2 bytes, a weight once a call.

- The four temporal modules' sites (``sites``): ``layer_3`` and
  ``layer_4`` at the third and fourth reassembly widths, at the patch
  grid and at its 3x3 s2 conv's output; ``path_4`` and ``path_3`` at
  ``features``, at the patch grid and twice it.
- A call's clips (``clip_lengths``): each finger's frames of the call cut
  into consecutive clips of ``num_frames``, the last one shorter where
  they do not divide.
- ``module_ops``: the ops of one temporal module over a call's images,
  each with its FLOPs and bytes: GroupNorm, ``proj_in``; per attention
  block LayerNorm, the table's add, the q, k, v projections (one C -> 3C
  product), the attention core (``4 t^2 C`` a clip and position: q k^T
  and the probabilities times v; q, k and v read, the output written),
  ``to_out``, the residual add; the feed-forward's LayerNorm, W1 (C ->
  8C), GEGLU, W2 (4C -> C), its residual add; ``proj_out`` and the
  module's residual add. An elementwise op's FLOPs are nominal (its
  bytes bound it).
- ``call_flops``: the DPT's (``yardstick_dpt.call_flops``) plus the
  modules' products and attention cores; ``temporal_bound_ms``: the
  modules' least time, each op the larger of its FLOPs at the bf16 peak
  and its bytes at the bandwidth, summed; ``temporal_attention_bound_ms``
  the same of the attention cores alone.
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark import yardstick_dpt
from benchmark.reference.dpt import grid
from benchmark.yardstick import Peaks
from benchmark.yardstick_dpt import ELEM_BYTES, Op, op_ms

ATTENTION_BLOCKS = 2


def sites(cfg: dict) -> List[Tuple[str, int, int]]:
    """(site, channels, positions a frame) of the four modules."""
    d = cfg["dpt"]
    oc, f = d["out_channels"], d["features"]
    gh, gw = grid(cfg)
    g = gh * gw
    return [("layer3", oc[2], g), ("layer4", oc[3], ((gh + 1) // 2) * ((gw + 1) // 2)),
            ("path4", f, g), ("path3", f, 4 * g)]


def clip_lengths(cfg: dict, dual_frames: int) -> List[int]:
    """The lengths of a call's clips, both fingers'."""
    t = cfg["dpt"]["num_frames"]
    whole, rest = divmod(dual_frames, t)
    return 2 * ([t] * whole + ([rest] if rest else []))


def module_ops(c: int, positions: int, lengths: List[int]) -> List[Op]:
    """One temporal module's ops over the clips' images, at ``c`` channels
    and ``positions`` a frame."""
    m = positions * sum(lengths)  # tokens
    b = ELEM_BYTES

    def linear(name, cin, cout, bias=True):
        return Op(name, 2.0 * m * cin * cout, b * (m * cin + cin * cout + (cout if bias else 0) + m * cout))

    def norm(name):
        return Op(name, 8.0 * m * c, b * (2 * m * c + 2 * c))

    def add(name):
        return Op(name, 1.0 * m * c, b * 3 * m * c)

    ops = [norm("group_norm"), linear("proj_in", c, c)]
    for j in range(ATTENTION_BLOCKS):
        ops += [norm(f"norm{j}"), add(f"pe{j}"), linear(f"qkv{j}", c, 3 * c, bias=False),
                Op(f"attention{j}", 4.0 * positions * sum(t * t for t in lengths) * c, b * 4 * m * c),
                linear(f"to_out{j}", c, c), add(f"residual{j}")]
    ops += [norm("ff_norm"), linear("ff_w1", c, 8 * c),
            Op("geglu", 9.0 * m * 4 * c, b * (8 * m * c + 4 * m * c)), linear("ff_w2", 4 * c, c), add("ff_residual"),
            linear("proj_out", c, c), add("residual")]
    return ops


def call_ops(cfg: dict, dual_frames: int) -> List[Op]:
    """The four modules' ops over a call."""
    lengths = clip_lengths(cfg, dual_frames)
    return [op for _, c, p in sites(cfg) for op in module_ops(c, p, lengths)]


def temporal_flops(cfg: dict, dual_frames: int) -> float:
    """The modules' model FLOPs a call: their matrix products and
    attention cores."""
    return sum(op.flops for op in call_ops(cfg, dual_frames)
               if op.name.startswith(("proj_", "qkv", "attention", "to_out", "ff_w")))


def call_flops(cfg: dict, dual_frames: int) -> float:
    """Model FLOPs of a serving call: the DPT's and the temporal modules'."""
    return yardstick_dpt.call_flops(cfg, dual_frames) + temporal_flops(cfg, dual_frames)


def temporal_bound_ms(cfg: dict, dual_frames: int, peaks: Peaks) -> float:
    return sum(op_ms(op, peaks) for op in call_ops(cfg, dual_frames))


def temporal_attention_bound_ms(cfg: dict, dual_frames: int, peaks: Peaks) -> float:
    return sum(op_ms(op, peaks) for op in call_ops(cfg, dual_frames) if op.name.startswith("attention"))
