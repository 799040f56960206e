"""The whole serving call's share of the card's peak, in %: the model's
conv FLOPs of the slice's calls (``yardstick.call_flops``) over the
slice's host time, over the peak of the configuration's precision (int8:
the int8 peak, its few float convs counted at it too). Nothing without
device ops."""

from benchmark import yardstick


def read(trace, ctx):
    if not trace.has_device_ops():
        return None
    cfg = ctx["config"]
    flops = yardstick.call_flops(cfg, ctx["traffic"]["dual_frames_per_call"]) * trace.units
    return 100.0 * flops / trace.window_s / ctx["peaks"].compute(cfg["precision"])
