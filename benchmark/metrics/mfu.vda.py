"""The video depth model's serving call's share of the card's bf16 peak,
in %: the configuration's FLOPs a call (``yardstick_vda.call_flops``: the
DPT's and the temporal modules') times the slice's calls, over the
slice's host time, over the peak. Nothing without device ops."""

from benchmark import yardstick_vda


def read(trace, ctx):
    if not trace.has_device_ops():
        return None
    flops = yardstick_vda.call_flops(ctx["config"], ctx["traffic"]["dual_frames_per_call"]) * trace.units
    return 100.0 * flops / trace.window_s / ctx["peaks"].bf16_flops
