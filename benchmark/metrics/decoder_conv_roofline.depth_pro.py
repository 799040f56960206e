"""Depth Pro's decoder convs' share of their roofline, in %: the least time
a call of the projection-upsample blocks', the decoder's and the head's
convs and transposed convs (``yardstick_depth_pro.decoder_ops`` but its
ReLUs, bias-ReLUs and adds; each op the larger of its FLOPs at the bf16
peak and its bytes once at the bandwidth, summed) over the device ms a
call launched inside the program's ``head.conv`` spans, each of which
holds one conv call and nothing else. Nothing from a trace without those
spans or device ops."""

from benchmark import spans, yardstick_depth_pro
from benchmark.yardstick_dpt import op_ms


def read(trace, ctx):
    ms = spans.reading(trace, "device_ms_within", "head.conv")
    if not ms:
        return None
    images = 2 * ctx["traffic"]["dual_frames_per_call"]
    bound = sum(op_ms(op, ctx["peaks"]) for op in yardstick_depth_pro.decoder_ops(ctx["config"], images)
                if op.name.rsplit(".", 1)[-1] not in yardstick_depth_pro.ELEMENTWISE)
    return 100.0 * bound / ms
