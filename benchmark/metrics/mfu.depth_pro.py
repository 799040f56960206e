"""Depth Pro's serving call's share of the card's bf16 peak, in %: the
configuration's FLOPs a call (``yardstick_depth_pro.call_flops``: the 36
ViT passes a finger image, the upsample blocks, the decoder and the head)
times the slice's calls, over the slice's host time, over the peak.
Nothing without device ops."""

from benchmark import yardstick_depth_pro


def read(trace, ctx):
    if not trace.has_device_ops():
        return None
    flops = yardstick_depth_pro.call_flops(ctx["config"], ctx["traffic"]["dual_frames_per_call"]) * trace.units
    return 100.0 * flops / trace.window_s / ctx["peaks"].bf16_flops
