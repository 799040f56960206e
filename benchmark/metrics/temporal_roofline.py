"""The temporal modules' share of their roofline, in %: their least time a
call (``yardstick_vda.temporal_bound_ms``: each op's FLOPs at the bf16
peak or its bytes once at the bandwidth, the larger, summed over the
four modules) over the device ms a call launched inside the program's
``dpt.temporal`` spans. Nothing from a trace without those spans or
device ops."""

from benchmark import spans, yardstick_vda


def read(trace, ctx):
    ms = spans.reading(trace, "device_ms_within", "dpt.temporal")
    if not ms:
        return None
    return 100.0 * yardstick_vda.temporal_bound_ms(ctx["config"], ctx["traffic"]["dual_frames_per_call"],
                                                   ctx["peaks"]) / ms
