"""The attention core's share of its roofline, in %: its least time a call
(``yardstick_dpt.attention_bound_ms``: 4 T^2 D FLOPs a block and image at
the bf16 peak, or q, k and v read and the output written at the
bandwidth, the larger) over the device ms a call launched inside the
program's ``dpt.attention`` spans (the heads' split, the attention, the
merge). Nothing from a trace without those spans or device ops."""

from benchmark import spans, yardstick_dpt


def read(trace, ctx):
    ms = spans.reading(trace, "device_ms_within", "dpt.attention")
    if not ms:
        return None
    images = 2 * ctx["traffic"]["dual_frames_per_call"]
    return 100.0 * yardstick_dpt.attention_bound_ms(ctx["config"], images, ctx["peaks"]) / ms
