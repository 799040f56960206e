"""Depth Pro's encoder blocks' share of their roofline, in %: the least time
a call of the 36 ViT passes a finger image (``yardstick_depth_pro
.vit_bound_ms``: ``yardstick_dpt.vit_bound_ms`` at the tile's 577 tokens)
over the device ms a call launched inside the program's ``dpt.block``
spans, both encoders'. Nothing from a trace without those spans or device
ops."""

from benchmark import spans, yardstick_depth_pro


def read(trace, ctx):
    ms = spans.reading(trace, "device_ms_within", "dpt.block")
    if not ms:
        return None
    images = 2 * ctx["traffic"]["dual_frames_per_call"]
    return 100.0 * yardstick_depth_pro.vit_bound_ms(ctx["config"], images, ctx["peaks"]) / ms
