"""The temporal attention cores' share of their roofline, in %: their
least time a call (``yardstick_vda.temporal_attention_bound_ms``: 4 t^2 C
FLOPs a clip, position and attention block at the bf16 peak, or q, k
and v read and the output written at the bandwidth, the larger) over the
device ms a call launched inside the program's ``dpt.temporal_attention``
spans (the heads' split, the attention, the merge). Nothing from a trace
without those spans or device ops."""

from benchmark import spans, yardstick_vda


def read(trace, ctx):
    ms = spans.reading(trace, "device_ms_within", "dpt.temporal_attention")
    if not ms:
        return None
    return 100.0 * yardstick_vda.temporal_attention_bound_ms(
        ctx["config"], ctx["traffic"]["dual_frames_per_call"], ctx["peaks"]) / ms
