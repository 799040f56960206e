"""The encoder blocks' share of their roofline, in %: the blocks' least
time a call (``yardstick_dpt.vit_bound_ms``: each op's FLOPs at the bf16
peak or its bytes at the bandwidth, the larger, summed) over the device
ms a call launched inside the program's ``dpt.block`` spans. Nothing from
a trace without those spans or device ops."""

from benchmark import spans, yardstick_dpt


def read(trace, ctx):
    ms = spans.reading(trace, "device_ms_within", "dpt.block")
    if not ms:
        return None
    images = 2 * ctx["traffic"]["dual_frames_per_call"]
    return 100.0 * yardstick_dpt.vit_bound_ms(ctx["config"], images, ctx["peaks"]) / ms
