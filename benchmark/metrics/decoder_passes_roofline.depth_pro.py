"""The share of their roofline of the passes between Depth Pro's decoder
convs, in %: the least time a call of the ReLUs, bias-ReLUs and residual
and outer adds of ``yardstick_depth_pro.decoder_ops`` (each its bytes
once at the bandwidth, summed) over the device ms a call launched inside
the program's ``depth_pro.upsample``, ``depth_pro.fusion`` and
``depth_pro.head`` spans but outside their ``head.conv`` spans: the
``conv_epilogue`` launches, ReLUs, adds, the concat and whatever else runs
there. With ``decoder_conv_roofline.depth_pro`` it splits the device ms
that ``decoder_roofline.depth_pro`` divides by. Nothing from a trace
without those spans or device ops."""

from benchmark import spans, yardstick_depth_pro
from benchmark.yardstick_dpt import op_ms

SPANS = ("depth_pro.upsample", "depth_pro.fusion", "depth_pro.head")
CONV = "head.conv"


def read(trace, ctx):
    if not spans.reading(trace, "device_ms_within", CONV):
        return None
    ms = sum(spans.reading(trace, "device_ms_within", name, CONV) for name in SPANS)
    if not ms:
        return None
    images = 2 * ctx["traffic"]["dual_frames_per_call"]
    bound = sum(op_ms(op, ctx["peaks"]) for op in yardstick_depth_pro.decoder_ops(ctx["config"], images)
                if op.name.rsplit(".", 1)[-1] in yardstick_depth_pro.ELEMENTWISE)
    return 100.0 * bound / ms
