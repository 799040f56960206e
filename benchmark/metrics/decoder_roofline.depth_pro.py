"""Depth Pro's decoder's share of its roofline, in %: the least time a call
of every conv, transposed conv, ReLU and residual add of the
projection-upsample blocks, the decoder and the head
(``yardstick_depth_pro.decoder_bound_ms``: each op's FLOPs at the bf16
peak or its bytes once at the bandwidth, the larger, summed) over the
device ms a call launched inside the program's ``depth_pro.upsample``,
``depth_pro.fusion`` and ``depth_pro.head`` spans. Nothing from a trace
without those spans or device ops."""

from benchmark import spans, yardstick_depth_pro

SPANS = ("depth_pro.upsample", "depth_pro.fusion", "depth_pro.head")


def read(trace, ctx):
    ms = sum(spans.reading(trace, "device_ms_within", name) or 0.0 for name in SPANS)
    if not ms:
        return None
    images = 2 * ctx["traffic"]["dual_frames_per_call"]
    return 100.0 * yardstick_depth_pro.decoder_bound_ms(ctx["config"], images, ctx["peaks"]) / ms
